"""Server roles: master, proxy, resolver, tlog, storage, and cluster wiring.

Reference layer 3 (fdbserver/). Each role is a plain class bound to a
SimProcess; request handlers register on well-known endpoint tokens
(fdbserver/WorkerInterface.h pattern).
"""
