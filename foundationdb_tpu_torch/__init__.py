"""foundationdb_tpu_torch — the PyTorch/CUDA port of foundationdb_tpu.

The JAX package beside it is the reference; this package mirrors its layout
and names so each module has a findable counterpart. It imports torch and
numpy, never jax and nothing of foundationdb_tpu: framework-free modules it
needs are kept here as its own copies.

This slice ports the resolver role end to end: the actor runtime it runs in
(core), its request/reply structs (server/interfaces.py), the conflict engine
(ops/conflict.py) whose device step is plain PyTorch (ops/conflict_ref.py)
plus four hand-written Hopper kernels (ops/kernels.py, csrc/*.cu).
"""

__version__ = "0.1.0"
