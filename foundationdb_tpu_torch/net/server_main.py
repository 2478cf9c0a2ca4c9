"""Server process entry point: run roles over the real transport.

The port's copy of foundationdb_tpu/net/server_main.py. Reference:
fdbserver/fdbserver.actor.cpp main + worker.actor.cpp — one OS process hosts
a set of roles listening on one address. The role spec comes in as JSON on
argv (the stand-in for command-line flags + cluster file):

  python -m foundationdb_tpu_torch.net.server_main '{"listen":
      "127.0.0.1:4500", "data_dir": "/path/to/data",
      "knobs": {"CONFLICT_BACKEND": "device"},
      "roles": [{"role": "master", ...}, ...]}'

Role args mirror the sim worker's InitRoleRequest args, with endpoint
dictionaries {"address": ..., "token": ...} converted to Endpoints. A role
may carry its own "listen" address: the process then opens one more
NetTransport there, on the same loop, so that two roles of one kind (two
resolvers sharing the card's context, two storage replicas) each own their
tokens; roles without one listen on the spec's address. Every
role is the port's; a resolver's engine runs where the knobs say, and the
default is the card (CONFLICT_BACKEND "device", CONFLICT_DEVICE "cuda"). A
process that hosts a resolver on a device or sharded backend whose device
is missing (a CUDA device where CUDA is not available) exits non-zero with
platform_error before it listens or prints `ready`; only a spec whose
knobs say CONFLICT_DEVICE=cpu runs the engine's plain PyTorch path on the
CPU. A process without a resolver builds no engine and never touches the
card, whatever its knobs say: only the resolvers' process holds a CUDA
context.

SIGTERM stops the loop and unwinds through `finally`: the trace and counter
dumps, the transport's close, the readback threads joined, the roles
dropped and the card's queue drained, then exit 0.
"""

from __future__ import annotations

import json
import sys


def _to_endpoint(v):
    from foundationdb_tpu_torch.core.sim import Endpoint
    if isinstance(v, dict) and set(v) == {"address", "token"}:
        return Endpoint(v["address"], v["token"])
    if isinstance(v, list):
        return [_to_endpoint(x) for x in v]
    return v


def build_role(process, role: str, args: dict):
    args = {k: _to_endpoint(v) for k, v in args.items()}
    if role == "master":
        from foundationdb_tpu_torch.server.master import Master
        return Master(process, **args)
    if role == "proxy":
        from foundationdb_tpu_torch.server.proxy import (Proxy, ResolverMap,
                                                         ShardMap)
        args["resolvers"] = ResolverMap(
            boundaries=[bytes.fromhex(b) for b in args["resolvers"]["boundaries"]],
            endpoints=_to_endpoint(args["resolvers"]["endpoints"]))
        args["shards"] = ShardMap(
            boundaries=[bytes.fromhex(b) for b in args["shards"]["boundaries"]],
            tags=args["shards"]["tags"])
        return Proxy(process, **args)
    if role == "grv_proxy":
        from foundationdb_tpu_torch.server.proxy import Proxy
        return Proxy(process, grv_only=True, **args)
    if role == "resolver":
        from foundationdb_tpu_torch.server.resolver import Resolver
        # key range rides the JSON spec hex-encoded (bytes aren't JSON);
        # absent/None end = "to the end of keyspace"
        if "key_range_begin" in args:
            args["key_range_begin"] = bytes.fromhex(args["key_range_begin"])
        if args.get("key_range_end") is not None:
            args["key_range_end"] = bytes.fromhex(args["key_range_end"])
        return Resolver(process, **args)
    if role == "tlog":
        from foundationdb_tpu_torch.server.tlog import TLog
        t = TLog(process, **args)
        t.recover_from_file()  # real deployments reboot onto surviving files
        return t
    if role == "storage":
        from foundationdb_tpu_torch.server.storage import StorageServer
        return StorageServer(process, **args)
    if role == "ratekeeper":
        from foundationdb_tpu_torch.server.ratekeeper import Ratekeeper
        return Ratekeeper(process, **args)
    raise ValueError(f"unknown role {role!r}")


def check_device():
    """The resolvers' engine device, resolved before anything listens: a
    device or sharded backend on a CUDA device that is not there raises
    platform_error (never a fallback to the CPU)."""
    from foundationdb_tpu_torch.utils import cudaenv
    from foundationdb_tpu_torch.utils.knobs import KNOBS
    if KNOBS.CONFLICT_BACKEND in ("device", "sharded"):
        cudaenv.resolve_device(KNOBS.CONFLICT_DEVICE)


def boot(loop, spec: dict):
    """The spec's transports (started) and roles on `loop`, built in the
    boot order below: ([transport, ...], [role, ...]), the spec's own
    address first."""
    from foundationdb_tpu_torch.net.transport import NetTransport
    nets: dict = {}

    def net_at(address):
        if address not in nets:
            net = nets[address] = NetTransport(loop, address,
                                               data_dir=spec.get("data_dir"))
            net.start()
        return nets[address]
    net_at(spec["listen"])
    # TLogs boot first so '@recover:local_tlog' args can fence version
    # allocation past what this process's logs durably reached — the static-
    # topology stand-in for coordinated recovery (a restarted master that
    # re-issues old versions would be silently ignored by storage; the
    # reference's master always recovers its version from the log system,
    # masterserver.actor.cpp recoverFrom).
    ordered = sorted(spec["roles"],
                     key=lambda r: 0 if r["role"] in ("tlog", "storage") else 1)
    roles = []
    built = {}
    for r in ordered:
        args = dict(r.get("args", {}))
        for k, v in args.items():
            if v == "@recover:local_tlog":
                tlogs = built.get("tlog", [])
                args[k] = max((t.version.get() for t in tlogs), default=0)
        net = net_at(r.get("listen", spec["listen"]))
        role = build_role(net.process, r["role"], args)
        built.setdefault(r["role"], []).append(role)
        roles.append(role)
    return list(nets.values()), roles


def shutdown(loop, nets, roles: list):
    """After the loop stopped: close the transports, join the readback
    threads (a readback in flight finishes its event wait), shut the roles
    down and drop them (the resolvers' graphs and pinned rings with them)
    and drain the card's queue, so no replay is cut off by the exit."""
    import gc
    for net in nets:
        net.close()
    if loop._pool is not None:
        loop._pool.shutdown(wait=True)
    for role in roles:
        shutdown = getattr(role, "shutdown", None)
        if shutdown is not None:
            shutdown()
    roles.clear()
    gc.collect()
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def main(spec_json: str) -> int:
    from foundationdb_tpu_torch.net.transport import RealEventLoop
    from foundationdb_tpu_torch.utils.errors import FDBError
    from foundationdb_tpu_torch.utils.knobs import KNOBS

    spec = json.loads(spec_json)
    for k, v in spec.get("knobs", {}).items():
        KNOBS.set(k, v)
    try:
        if any(r["role"] == "resolver" for r in spec["roles"]):
            check_device()
    except FDBError as e:
        print(f"error {e.name}: {e.detail}", file=sys.stderr, flush=True)
        return 1
    loop = RealEventLoop()
    nets, roles = boot(loop, spec)
    print(f"ready {spec['listen']} roles={[r['role'] for r in spec['roles']]}",
          flush=True)
    import os
    import signal
    # graceful SIGTERM always: unwind through finally so the transport
    # closes and, on device-backend servers, the readbacks finish and the
    # card's queue drains before the process exits
    signal.signal(signal.SIGTERM,
                  lambda *_a: loop.aio.call_soon_threadsafe(loop.aio.stop))
    prof_path = os.environ.get("FDBTPU_PROFILE")
    if prof_path:
        import cProfile
        pr = cProfile.Profile()
        pr.enable()
    sampler = None
    if os.environ.get("FDBTPU_SAMPLING_PROFILE"):
        from foundationdb_tpu_torch.utils.profiler import SamplingProfiler
        sampler = SamplingProfiler()
        sampler.start()
    trace_file = None
    trace_dir = os.environ.get("FDBTPU_TRACE_DIR")
    if trace_dir:
        # per-process rolling trace file (openTraceFile): span/counter
        # records land here instead of stderr, named by listen address so
        # trace_analyze can merge the whole cluster's files
        from foundationdb_tpu_torch.utils import trace
        trace_file = trace.RollingTraceFile(os.path.join(
            trace_dir, f"trace.{spec['listen'].replace(':', '_')}.jsonl"))
        trace.set_sink(trace_file.write)
    try:
        loop.aio.run_forever()
    finally:
        if prof_path:
            pr.disable()
            pr.dump_stats(f"{prof_path}.{spec['listen'].replace(':', '_')}")
        if sampler is not None:
            sampler.stop()
            sampler.trace_report(who=spec["listen"])
        if trace_file is not None:
            from foundationdb_tpu_torch.utils.trace import (g_trace_batch,
                                                            set_sink)
            # final counter dump: a short run may never reach the periodic
            # 5s tick, and the rollup wants end-of-run totals either way
            for role in roles:
                coll = getattr(role, "counters", None)
                if hasattr(coll, "trace"):
                    tc = role.process.net.transport_counters()
                    coll.trace(loop.now(), extra={"Transport" + k: v
                                                  for k, v in tc.items()})
            g_trace_batch.dump()  # buffered span records survive shutdown
            set_sink(None)
            trace_file.close()
        shutdown(loop, nets, roles)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
