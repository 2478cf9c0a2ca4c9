"""Management API: cluster configuration as transactions on \\xff/conf.

Reference: fdbclient/ManagementAPI.actor.cpp:1604 (changeConfig — configure
replication/engine via \\xff/conf keys), excludeServers/includeServers
(\\xff/conf/excluded rows the data distributor drains), and the fdbcli
commands over it (fdbcli.actor.cpp:430-518).

Everything here is an ordinary metadata transaction: it flows through every
resolver, lands in every proxy's txnStateStore, and is durable in the
database; the cluster controller's DD loop reads the configuration each
round and reacts (replication changes re-team via redundancy healing;
exclusions are treated as failed servers and drained the same way; txn-
subsystem shape changes apply at the next recovery, which the CC triggers).
"""

from __future__ import annotations

from foundationdb_tpu_torch.utils.errors import FDBError

CONF_PREFIX = b"\xff/conf/"
CONF_END = b"\xff/conf0"
EXCLUDED_PREFIX = b"\xff/conf/excluded/"
EXCLUDED_END = b"\xff/conf/excluded0"

# configure knobs with their validators (DatabaseConfiguration.cpp's
# parameter surface, trimmed to what this cluster models)
_INT_PARAMS = {"n_replicas", "n_proxies", "n_resolvers", "n_tlogs"}
_ENUM_PARAMS = {"storage_engine": {"memory", "ssd"},
                "conflict_backend": {"device", "sharded", "oracle"}}
# shorthand forms the reference's `configure` accepts
_ALIASES = {"single": ("n_replicas", 1), "double": ("n_replicas", 2),
            "triple": ("n_replicas", 3)}


def conf_key(name: str) -> bytes:
    return CONF_PREFIX + name.encode()


def parse_configure_args(args: list[str]) -> dict:
    """`configure triple storage_engine=ssd n_proxies=2` -> dict."""
    out: dict[str, object] = {}
    for a in args:
        if a in _ALIASES:
            k, v = _ALIASES[a]
            out[k] = v
        elif a in ("memory", "ssd"):
            out["storage_engine"] = a
        elif "=" in a:
            k, v = a.split("=", 1)
            if k in _INT_PARAMS:
                out[k] = int(v)
            elif k in _ENUM_PARAMS:
                if v not in _ENUM_PARAMS[k]:
                    raise FDBError("invalid_option_value", f"{k}={v}")
                out[k] = v
            else:
                raise FDBError("invalid_option_value", f"unknown option {k}")
        else:
            raise FDBError("invalid_option_value", f"unparsable `{a}'")
    return out


async def configure(db, **params) -> None:
    """changeConfig: write \\xff/conf keys transactionally."""
    for k, v in params.items():
        if k in _INT_PARAMS:
            # bool is an int subclass: b'True' in a conf row would be
            # unparsable for every later reader
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise FDBError("invalid_option_value", f"{k}={v}")
        elif k in _ENUM_PARAMS:
            if v not in _ENUM_PARAMS[k]:
                raise FDBError("invalid_option_value", f"{k}={v}")
        else:
            raise FDBError("invalid_option_value", f"unknown option {k}")

    async def body(tr):
        for k, v in params.items():
            await tr.get(conf_key(k))  # conflict on concurrent configure
            tr.set(conf_key(k), str(v).encode())
    await db.transact(body, max_retries=200)


async def get_configuration(db) -> dict:
    async def body(tr):
        rows = await tr.get_range(CONF_PREFIX, CONF_END)
        return rows
    rows = await db.transact(body, max_retries=200)
    out: dict[str, object] = {}
    excluded = []
    for k, v in rows:
        name = k[len(CONF_PREFIX):].decode(errors="replace")
        if name.startswith("excluded/"):
            excluded.append(name[len("excluded/"):])
        elif name in _INT_PARAMS:
            try:
                out[name] = int(v)
            except ValueError:
                pass  # a corrupt row (e.g. direct \xff write) must not
                # kill every conf reader — ignore it
        else:
            out[name] = v.decode(errors="replace")
    out["excluded"] = sorted(excluded)
    return out


async def exclude_servers(db, addrs: list[str]) -> None:
    """Mark servers excluded: the DD drains every shard off them (treated
    exactly like failed servers by redundancy healing), after which they
    hold no data and can be taken down safely."""
    async def body(tr):
        for a in addrs:
            tr.set(EXCLUDED_PREFIX + a.encode(), b"1")
    await db.transact(body, max_retries=200)


async def include_servers(db, addrs: list[str] | None = None) -> None:
    """Clear exclusions (all of them when addrs is None)."""
    async def body(tr):
        if addrs is None:
            tr.clear_range(EXCLUDED_PREFIX, EXCLUDED_END)
        else:
            for a in addrs:
                k = EXCLUDED_PREFIX + a.encode()
                tr.clear_range(k, k + b"\x00")
    await db.transact(body, max_retries=200)


async def excluded_servers(db) -> list[str]:
    async def body(tr):
        rows = await tr.get_range(EXCLUDED_PREFIX, EXCLUDED_END)
        return [k[len(EXCLUDED_PREFIX):].decode() for k, _v in rows]
    return await db.transact(body, max_retries=200)
