"""The port's C-API bindings and conformance tester against the JAX ones.

tests/test_bindingtester.py's two tests run on the port's surface
(foundationdb_tpu_torch/bindings/): the fdb_c.h lifecycle, future and
error-mapping contract, the seeded conformance stream through the C-ABI
machine and the native client, compared stack for stack and row for row,
against a port server_main cluster whose resolver runs the port's engine
on the CPU (plain phases); and the MultiVersionApi's selection rules.

Held to the JAX package: `gen_ops` gives the same stream in both; the
port's C-API machine against a port cluster and the JAX one against a JAX
cluster (booted as tests/test_torch_transport.py boots one) leave equal
stacks and equal final rows for seed 977 x 2,000 ops; and each package's
client runs the conformance stream against the other package's cluster.

Each test resets both packages' fdb_c network singletons and stops their
network threads even when an assertion fails.
"""

import contextlib
import threading
import types

import pytest

from foundationdb_tpu_torch.bindings import bindingtester, fdb_c
from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS
from test_torch_transport import (SHAPE_KNOBS, cluster_specs, free_addr,
                                  start_server, stop_servers)

PORT_KNOBS = {"CONFLICT_BACKEND": "device", "CONFLICT_DEVICE": "cpu",
              **SHAPE_KNOBS}
MODULES = {"port": "foundationdb_tpu_torch.net.server_main",
           "jax": "foundationdb_tpu.net.server_main"}


@pytest.fixture(autouse=True)
def _knobs():
    TKNOBS.reset()
    yield
    TKNOBS.reset()


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """One two-process cluster of each package: the port's with its
    device engine on the CPU, the JAX package's on its oracle (as the
    cross-package transport tests boot it). -> {package: (proxy, storage)}"""
    procs, out = [], {}
    try:
        for pkg, knobs in (("port", PORT_KNOBS),
                           ("jax", {"CONFLICT_BACKEND": "oracle"})):
            tmp = tmp_path_factory.mktemp(pkg)
            specs = cluster_specs(tmp, knobs)
            for spec in specs:
                procs.append(start_server(MODULES[pkg], spec,
                                          log_path=tmp / "servers.log"))
            out[pkg] = (specs[0]["listen"], specs[1]["listen"])
            warm_up(pkg, *out[pkg])
        yield out
    finally:
        assert stop_servers(procs) == [0] * len(procs)


def warm_up(pkg, proxy, storage):
    """One commit, so that every read version the tests see is above 0: a
    cluster that has committed nothing answers a GRV with 0, and the
    tester's GRV entry (`v > 0`) would then depend on which machine ran
    first."""
    async def write(tr):
        tr.set(b"warm", b"up")
    with native_database(pkg, proxy, storage) as (loop, db):
        loop.run_future(loop.spawn(db.transact(write, max_retries=50)),
                        max_time=60.0)


def package(pkg):
    """(fdb_c, bindingtester, Database, LocationCache, NetTransport,
    RealEventLoop) of one package."""
    if pkg == "port":
        from foundationdb_tpu_torch.client.database import (Database,
                                                            LocationCache)
        from foundationdb_tpu_torch.net.transport import (NetTransport,
                                                          RealEventLoop)
        return types.SimpleNamespace(
            fdb_c=fdb_c, bindingtester=bindingtester, Database=Database,
            LocationCache=LocationCache, NetTransport=NetTransport,
            RealEventLoop=RealEventLoop)
    from foundationdb_tpu.bindings import bindingtester as j_bt
    from foundationdb_tpu.bindings import fdb_c as j_fdb_c
    from foundationdb_tpu.client.database import Database, LocationCache
    from foundationdb_tpu.net.transport import NetTransport, RealEventLoop
    return types.SimpleNamespace(
        fdb_c=j_fdb_c, bindingtester=j_bt, Database=Database,
        LocationCache=LocationCache, NetTransport=NetTransport,
        RealEventLoop=RealEventLoop)


@contextlib.contextmanager
def capi_network(capi):
    """A selected version and a running network thread of one fdb_c
    module; stopped, joined and reset on the way out."""
    capi._reset_for_tests()
    thread = None
    try:
        assert capi.fdb_select_api_version(610) == 0
        assert capi.fdb_setup_network() == 0
        thread = threading.Thread(target=capi.fdb_run_network, daemon=True)
        thread.start()
        yield
    finally:
        if thread is not None:
            capi.fdb_stop_network()
            thread.join(timeout=10)
            assert not thread.is_alive()
        capi._reset_for_tests()


def capi_database(capi, proxy, storage):
    err, db = capi.fdb_create_database({"proxies": [proxy],
                                        "boundaries": [b""],
                                        "storages": [[storage]]})
    assert err == 0 and db is not None
    return db


@contextlib.contextmanager
def native_database(pkg, proxy, storage):
    """(loop, Database) of one package's native client on its own loop."""
    ns = package(pkg)
    loop = ns.RealEventLoop()
    client = ns.NetTransport(loop, free_addr())
    client.start()
    try:
        yield loop, ns.Database(client.process, proxies=[proxy],
                                locations=ns.LocationCache([b""],
                                                           [[storage]]))
    finally:
        client.close()


def test_capi_surface_and_bindingtester(clusters):
    proxy, storage = clusters["port"]
    fdb_c._reset_for_tests()
    net_thread = None
    try:
        # the fdb_c.h lifecycle contract
        assert fdb_c.fdb_setup_network() != 0, \
            "setup before version must fail"
        assert fdb_c.fdb_select_api_version(fdb_c.HEADER_API_VERSION + 1) != 0
        assert fdb_c.fdb_select_api_version(610) == 0
        assert fdb_c.fdb_select_api_version(610) == 0  # idempotent re-select
        assert fdb_c.fdb_setup_network() == 0
        assert fdb_c.fdb_setup_network() != 0, "double setup must fail"
        net_thread = threading.Thread(target=fdb_c.fdb_run_network,
                                      daemon=True)
        net_thread.start()
        db = capi_database(fdb_c, proxy, storage)

        # basic future semantics: get on an empty key, callback delivery
        tr = db.create_transaction()
        fut = tr.get(b"bt_c/none")
        assert fut.block_until_ready() == 0 and fut.is_ready()
        err, present, v = fut.get_value()
        assert (err, present, v) == (0, False, None)
        fired = threading.Event()
        fut2 = tr.get_read_version()
        fut2.set_callback(lambda f, arg: fired.set(), None)
        fut2.block_until_ready()
        assert fired.wait(5.0)
        # error mapping: a conflict surfaces as the not_committed CODE
        assert fdb_c.fdb_get_error(1020) == "not_committed"
        assert fdb_c.fdb_error_predicate("RETRYABLE", 1020)
        assert fdb_c.fdb_error_predicate("MAYBE_COMMITTED", 1021)
        assert not fdb_c.fdb_error_predicate("RETRYABLE", 4100)

        # the conformance run: identical seeded streams through the C-ABI
        # machine and the native client, stacks + final data must match
        with native_database("port", proxy, storage) as (loop, ndb):
            checked = bindingtester.compare_runs(977, 2000, db, loop, ndb)
            checked += bindingtester.compare_runs(
                31337, 1000, db, loop, ndb, prefix_c=b"bt2_c/",
                prefix_n=b"bt2_n/")
        assert checked > 500
    finally:
        if net_thread is not None:
            fdb_c.fdb_stop_network()
            net_thread.join(timeout=10)
        fdb_c._reset_for_tests()


def test_multiversion_client_selection():
    """MultiVersionApi selection rules (MultiVersionTransaction.actor.cpp):
    registration gates, most-compatible-library election, unsupported
    versions rejected, disable option pinning the local client."""
    from foundationdb_tpu_torch.bindings.multiversion import MultiVersionApi

    def fake_client(max_api):
        m = types.SimpleNamespace()
        m.fdb_get_max_api_version = lambda: max_api
        m.fdb_select_api_version = lambda v: 0 if v <= max_api else 1
        m.fdb_create_database = lambda cluster: (0, ("db", max_api))
        return m

    try:
        api = MultiVersionApi()
        assert api.add_external_client("v700", fake_client(700)) == 0
        assert api.add_external_client("v520", fake_client(520)) == 0
        assert api.add_external_client("bogus", object()) != 0  # no surface
        # version above every library -> rejected
        assert api.fdb_select_api_version(800) != 0
        # 600 fits v700 and the local 610 library but NOT v520: the
        # election picks the most compatible (smallest max >= 600) = local
        fdb_c._reset_for_tests()
        assert api.fdb_select_api_version(600) == 0
        assert api.active_client is fdb_c
        # re-select with a different version fails; same is idempotent
        assert api.fdb_select_api_version(520) != 0
        assert api.fdb_select_api_version(600) == 0
        # surface delegation reaches the active client
        assert api.fdb_get_max_api_version() == fdb_c.HEADER_API_VERSION

        # a 500-level request elects the v520 library over local/700
        api2 = MultiVersionApi()
        api2.add_external_client("v700", fake_client(700))
        api2.add_external_client("v520", fake_client(520))
        fdb_c._reset_for_tests()
        assert api2.fdb_select_api_version(500) == 0
        assert api2.fdb_get_max_api_version() == 520
        err, db = api2.fdb_create_database({})
        assert (err, db) == (0, ("db", 520))

        # disable option pins the local client regardless of externals
        api3 = MultiVersionApi()
        api3.add_external_client("v520", fake_client(520))
        assert api3.disable_multi_version_client_api() == 0
        fdb_c._reset_for_tests()
        assert api3.fdb_select_api_version(500) == 0
        assert api3.active_client is fdb_c
    finally:
        fdb_c._reset_for_tests()


@pytest.mark.parametrize("seed,n", [(977, 2000), (31337, 1000)])
def test_gen_ops_is_the_jax_packages_stream(seed, n):
    from foundationdb_tpu.bindings import bindingtester as j_bt
    assert bindingtester.gen_ops(seed, n) == j_bt.gen_ops(seed, n)
    assert bindingtester.OPS == j_bt.OPS and bindingtester.N_KEYS == \
        j_bt.N_KEYS


def test_capi_machines_of_both_packages_leave_equal_stacks_and_rows(
        clusters):
    """Seed 977 x 2,000 ops: the port's C-API machine against the port's
    cluster and the JAX one against the JAX cluster."""
    ops = bindingtester.gen_ops(977, 2000)
    runs = {}
    for pkg in ("port", "jax"):
        ns = package(pkg)
        with capi_network(ns.fdb_c):
            db = capi_database(ns.fdb_c, *clusters[pkg])
            machine = ns.bindingtester.CApiMachine(db, b"xpkg_c/")
            machine.run(ops)
            runs[pkg] = (machine.stack, machine.final_rows())
    (p_stack, p_rows), (j_stack, j_rows) = runs["port"], runs["jax"]
    assert len(p_stack) == len(j_stack) > 500
    for i, (a, b) in enumerate(zip(p_stack, j_stack)):
        assert a == b, f"stack[{i}]: port {a} jax {b}"
    assert p_rows == j_rows and len(p_rows) > 0


@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port")])
def test_each_packages_client_against_the_others_cluster(clusters, client,
                                                         server):
    """One package's C-API machine and native client run the conformance
    stream against the other package's cluster, stacks and rows equal."""
    ns = package(client)
    prefix = f"x_{client}_".encode()
    with capi_network(ns.fdb_c):
        db = capi_database(ns.fdb_c, *clusters[server])
        with native_database(client, *clusters[server]) as (loop, ndb):
            checked = ns.bindingtester.compare_runs(
                31337, 600, db, loop, ndb, prefix_c=prefix + b"c/",
                prefix_n=prefix + b"n/")
    assert checked > 150
