"""multimodal_flows — multimodal generative flows for LHC jets in JAX.

A from-scratch JAX/XLA framework with the capabilities of the
reference `dfaroughy/Multimodal-flows` (PyTorch-Lightning):

- Conditional Flow Matching (CFM) for continuous particle kinematics
- Markov Jump Bridges (MJB, multivariate random-telegraph) for discrete flavor tokens
- MMF: the joint multimodal flow bridge, trained with multitask losses and
  sampled with a fused Euler-ODE + tau-leaping solver inside one `lax.scan`.

Design: pure functional dynamics with explicit PRNG keys, one jitted train
step (loss + grad + optax + EMA) sharded over a `jax.sharding.Mesh`, and
static shapes (padded or packed particle clouds).
"""

__version__ = "0.1.0"

from multimodal_flows.data.state import MultiModal, DataCoupling

__all__ = ["MultiModal", "DataCoupling", "__version__"]
