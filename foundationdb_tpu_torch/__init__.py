"""foundationdb_tpu_torch — the PyTorch/CUDA port of foundationdb_tpu.

The JAX package beside it is the reference; this package mirrors its layout
and names so each module has a findable counterpart. It imports torch and
numpy, never jax and nothing of foundationdb_tpu: framework-free modules it
needs are kept here as its own copies.

It ports the commit pipeline under simulation (server/cluster.py's
SimCluster: master, proxies, resolvers, tlogs, storage servers, and the
client in client/), the actor runtime it runs in (core), and the
resolver's conflict engine (ops/conflict.py) whose device step is plain
PyTorch (ops/conflict_ref.py) plus hand-written Hopper kernels
(ops/kernels.py, csrc/*.cu). And it ports the kernel bench (bench.py)
with the Pallas A/B probes (ops/probes.py), recovery, the randomized
simulation harness (testing/), backup, restore and DR (backup/, with the
blob store's HTTP in net/http.py), the client layers (layers/), the real
transport and the server processes (net/: transport.py, server_main.py)
and the operator tools fdbbackup, fdbcli, fdbmonitor, networktest and
trace_analyze (tools/). It ports the C-ABI client bindings with their
multiversion loader and conformance tester (bindings/), the driver entry
points (graft_entry.py), the C extension's sanitizer harness
(native/sanitize.py) and the static analyzers with their four rule
families, flow, dev (torch rules), proto and nat (analysis/).
"""

__version__ = "0.1.0"
