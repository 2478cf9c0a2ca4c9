"""Networking: the real transport (transport.py: NetProcess, NetTransport,
RealEventLoop, exported here as in the JAX package's net/), its framing
(native_transport.py), TLS (tls.py), the server entry point
(server_main.py) and the blob store's HTTP client and server (http.py).
The exports load on first use, so importing net.http alone does not load
the transport."""

_EXPORTS = ("NetProcess", "NetTransport", "RealEventLoop")


def __getattr__(name):
    if name in _EXPORTS:
        from foundationdb_tpu_torch.net import transport
        return getattr(transport, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
