"""Tutorial: colored 8-Gaussians -> 2-moons multimodal flow.

Script equivalent of the reference tutorial notebook
(`notebooks/Tutorial_Colored_8Gaussians_to_2Moons.ipynb`): train a small
MLP multimodal flow (CFM for positions + telegraph bridge for the color
label) on the toy coupling, then sample full trajectories with the hybrid
tau-leaping solver and plot the paths.

Run:  python examples/toy_tutorial.py [--epochs 200] [--out toy_out]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from multimodal_flows.config import Config
from multimodal_flows.data.datasets import ArrayDataset
from multimodal_flows.data.state import DataCoupling, MultiModal
from multimodal_flows.data.toy import NGaussians, TwoMoons
from multimodal_flows.train.systems import MMF
from multimodal_flows.train.trainer import Trainer
from multimodal_flows.utils.logger import SimpleLogger as log
from multimodal_flows.utils.plotting import (plot_trajectories,
                                                 plot_trajectory_panels)


def main(argv=None):
    p = argparse.ArgumentParser()
    # notebook recipe (cell 10): 20 epochs, lr 1e-3, n_embd 128,
    # sigma 0.1, beta 0.25, 80k-point coupling, batch 256
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--num_points", type=int, default=80_000)
    p.add_argument("--num_timesteps", type=int, default=200)
    p.add_argument("--out", type=str, default="toy_out")
    args = p.parse_args(argv)

    cfg = Config(
        model="ToyMLP", vocab_size=9, dim_continuous=2, max_num_particles=1,
        n_embd=128, n_inner=128, n_layer=3, batch_size=256,
        max_epochs=args.epochs, lr=1e-3, lr_final=1e-5,
        multitask_loss="sum", beta=0.25, sigma=0.1,
        dir=args.out, project="toy", seed=0,
    )
    cfg.mint_experiment_id()

    # toy coupling as in the reference tutorial: 8 colored gaussians (labels
    # 1..8) -> colored two moons (labels 1..2); vocab 9 covers both plus pad
    n_src = args.num_points
    src = NGaussians(num_points_per_gaussian=n_src // 8, num_gaussians=8, seed=0).as_clouds()
    tgt = TwoMoons(num_points_per_moon=n_src // 2, seed=1).as_clouds()
    ds = ArrayDataset(DataCoupling(source=src, target=tgt))
    train_ds, val_ds = ds.split(0.9, seed=0)

    system = MMF(cfg)
    trainer = Trainer(system, cfg, mesh=None)
    state = trainer.fit(train_ds, val_ds)

    # sample trajectories starting FROM fresh 8-Gaussians draws, exactly
    # like the notebook's generation dataloader (cell 12) — the model was
    # trained on 8-Gaussians sources, not standard-normal noise
    n = 2000
    gen_src = NGaussians(num_points_per_gaussian=n // 8, num_gaussians=8,
                         seed=7).as_clouds()
    source = MultiModal(
        time=jnp.full((n,), cfg.time_eps),
        continuous=jnp.asarray(gen_src.continuous),
        discrete=jnp.asarray(gen_src.discrete),
        mask=jnp.ones((n, 1, 1), jnp.int32),
    )
    final, traj = system.simulate(state.params, jax.random.PRNGKey(42), source,
                                  num_timesteps=args.num_timesteps,
                                  return_trajectory=True)

    out_png = os.path.join(cfg.experiment_dir, "trajectories.png")
    traj = jax.tree.map(np.asarray, traj)
    plot_trajectories(traj, num_points=600, path=out_png)
    plot_trajectory_panels(traj, num_points=600,
                           path=out_png.replace(".png", "_panels.png"))
    log.info(f"saved trajectory plots -> {out_png} (+_panels)")

    labels = np.asarray(final.discrete)[:, 0, 0]
    freq = np.bincount(labels, minlength=cfg.vocab_size) / n
    log.info(f"final label frequencies: {np.round(freq, 3)} "
             f"(target: ~0.5 each on labels 1 and 2, ~0 elsewhere)")

    # closure check: generated vs a fresh truth sample, per-axis W1 + plot
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from multimodal_flows.utils.metrics import wasserstein1d

    truth = TwoMoons(num_points_per_moon=n // 2, seed=9)
    gen_xy = np.asarray(final.continuous)[:, 0, :]
    w1x = wasserstein1d(gen_xy[:, 0], truth.continuous[:, 0])
    w1y = wasserstein1d(gen_xy[:, 1], truth.continuous[:, 1])
    log.info(f"W1(generated, truth): x={w1x:.3f} y={w1y:.3f} "
             f"(truth scale ~3; <0.3 is visually closed)")

    fig, axes = plt.subplots(1, 2, figsize=(8, 4))
    axes[0].scatter(gen_xy[:, 0], gen_xy[:, 1], c=labels, s=4,
                    cmap="tab10", vmin=0, vmax=9)
    axes[0].set_title("generated (t=1)")
    axes[1].scatter(truth.continuous[:, 0], truth.continuous[:, 1],
                    c=truth.discrete[:, 0], s=4, cmap="tab10", vmin=0, vmax=9)
    axes[1].set_title("target law")
    for ax in axes:
        ax.set_xticks([]); ax.set_yticks([]); ax.axis("equal")
    cmp_png = os.path.join(cfg.experiment_dir, "closure.png")
    fig.savefig(cmp_png, dpi=120, bbox_inches="tight")
    log.info(f"saved closure comparison -> {cmp_png}")


if __name__ == "__main__":
    main()
