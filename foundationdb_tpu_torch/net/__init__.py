"""Networking: this package has http.py (the blob store's HTTP client and
server) only. The JAX package's net/ also exports NetProcess, NetTransport
and RealEventLoop from transport.py, which the port does not have yet."""
