"""networktest: raw transport throughput/latency measurement.

Reference: fdbserver/networktest.actor.cpp (`fdbserver -r networktest`) — a
sender floods a receiver with fixed-size request/reply pairs over P parallel
streams and reports requests/sec plus latency percentiles; the tool that
separates "the database is slow" from "the wire is slow".

Run a receiver:   python -m foundationdb_tpu_torch.tools.networktest serve <addr>
Run a sender:     python -m foundationdb_tpu_torch.tools.networktest run <addr> \
                      [--streams 16] [--bytes 256] [--seconds 5]

Library use (tests / verify drives): start_receiver(process) registers the
echo token; run_load(...) drives it and returns the report dict.
"""

from __future__ import annotations

import time

NETWORK_TEST_TOKEN = 9000  # NetworkTestInterface's well-known endpoint


def start_receiver(process) -> None:
    """Echo server: replies with the payload (networktest's reply carries
    the configured reply size; echoing measures both directions)."""
    process.register(NETWORK_TEST_TOKEN, lambda req, reply: reply.send(req))


async def run_load(net, process, remote: str, streams: int = 16,
                   payload_bytes: int = 256, seconds: float = 5.0) -> dict:
    """P parallel request streams for `seconds`; returns
    {requests_per_sec, mbit_per_sec, p50_ms, p99_ms, requests}."""
    from foundationdb_tpu_torch.core.future import all_of
    from foundationdb_tpu_torch.core.sim import Endpoint
    from foundationdb_tpu_torch.utils.errors import FDBError

    loop = net.loop
    payload = b"x" * payload_bytes
    stop_at = loop.now() + seconds
    lat: list[float] = []
    count = [0]

    async def stream():
        ep = Endpoint(remote, NETWORK_TEST_TOKEN)
        while loop.now() < stop_at:
            t0 = loop.now()
            try:
                got = await net.request(process, ep, payload)
            except FDBError as e:
                if e.name == "operation_cancelled":
                    raise
                continue
            assert got == payload
            lat.append(loop.now() - t0)
            count[0] += 1

    tasks = [loop.spawn(stream(), name=f"nt{i}") for i in range(streams)]
    await all_of(tasks)
    lat.sort()
    n = count[0]
    return {
        "requests": n,
        "requests_per_sec": round(n / seconds, 1),
        "mbit_per_sec": round(n * payload_bytes * 2 * 8 / seconds / 1e6, 2),
        "p50_ms": round(1e3 * lat[n // 2], 3) if n else None,
        "p99_ms": round(1e3 * lat[int(n * 0.99)], 3) if n else None,
        "streams": streams,
        "payload_bytes": payload_bytes,
    }


def main(argv: list[str]) -> int:
    import json

    from foundationdb_tpu_torch.net.transport import NetTransport, RealEventLoop
    if not argv or argv[0] not in ("serve", "run"):
        print(__doc__)
        return 2
    mode, addr = argv[0], argv[1]
    opts = dict(zip(argv[2::2], argv[3::2]))
    loop = RealEventLoop()
    if mode == "serve":
        net = NetTransport(loop, addr)
        net.start()
        start_receiver(net.process)
        print(f"networktest receiver on {addr}", flush=True)
        loop.aio.run_forever()
        return 0
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    local = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    net = NetTransport(loop, local)
    net.start()

    async def go():
        return await run_load(
            net, net.process, addr,
            streams=int(opts.get("--streams", 16)),
            payload_bytes=int(opts.get("--bytes", 256)),
            seconds=float(opts.get("--seconds", 5.0)))
    report = loop.run_future(loop.spawn(go()),
                             max_time=60.0 + float(opts.get("--seconds", 5.0)))
    print(json.dumps(report))
    net.close()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main(sys.argv[1:]))
