"""fdbcli: the interactive operator shell.

Reference: fdbcli/fdbcli.actor.cpp (command table initHelp :430-518) — the
command surface operators use: get/set/clear/clearrange/getrange/status/
writemode/option/exit. This implementation drives any cluster through the
public client API; `main()` boots an in-process simulated cluster ("sandbox",
the analogue of exploring with `fdbserver -r simulation`) and runs a REPL
over stdin. Tests (and the future network transport) drive `FdbCli.execute`
directly.
"""

from __future__ import annotations

import json
import shlex


def _fmt_key(b: bytes) -> str:
    return repr(b)[2:-1]  # strip the b'...' wrapper (fdbcli's printable form)


class FdbCli:
    def __init__(self, cluster, db):
        self.cluster = cluster
        self.db = db
        self.write_mode = False
        self.out: list[str] = []

    def _print(self, s: str = ""):
        self.out.append(s)

    def execute(self, line: str) -> list[str]:
        """Run one command line to completion (drives the sim loop);
        returns the output lines."""
        self.out = []
        parts = shlex.split(line)
        if not parts:
            return []
        cmd, args = parts[0].lower(), parts[1:]
        handler = getattr(self, f"_cmd_{cmd}", None)
        if handler is None:
            self._print(f"ERROR: unknown command `{cmd}'. Try `help'.")
            return self.out
        task = self.cluster.loop.spawn(handler(args), name=f"fdbcli/{cmd}")
        try:
            self.cluster.run(task, max_time=self.cluster.loop.now() + 600.0)
        except SystemExit:
            raise
        except IndexError:
            self._print(f"ERROR: `{cmd}' is missing arguments. Try `help'.")
        except Exception as e:  # noqa: BLE001 — the shell must survive
            self._print(f"ERROR: {getattr(e, 'name', type(e).__name__)}")
        return self.out

    # -- commands (initHelp :430-518 surface) --

    async def _cmd_help(self, args):
        for line in ("clear <KEY> — clear a key",
                     "clearrange <BEGINKEY> <ENDKEY> — clear a range",
                     "configure [single|double|triple] [memory|ssd] "
                     "[k=v]... — change the database configuration",
                     "coordinators — show the coordination servers",
                     "exclude [ADDRESS...] — exclude servers from the cluster"
                     " (no args: list exclusions)",
                     "get <KEY> — fetch the value for a given key",
                     "getrange <BEGINKEY> [ENDKEY] [LIMIT] — fetch key/value pairs",
                     "include <ADDRESS...|all> — re-include excluded servers",
                     "set <KEY> <VALUE> — set a value for a given key",
                     "status [json] — cluster status",
                     "writemode <on|off> — enables or disables sets and clears",
                     "help — this help",
                     "exit — exit the CLI"):
            self._print(line)

    # -- management commands (ManagementAPI.actor.cpp over \xff/conf) --

    async def _cmd_configure(self, args):
        from foundationdb_tpu_torch.client import management
        if not args:
            conf = await management.get_configuration(self.db)
            self._print(json.dumps(conf, indent=2, default=str))
            return
        params = management.parse_configure_args(args)
        await management.configure(self.db, **params)
        self._print("Configuration changed")

    async def _cmd_exclude(self, args):
        from foundationdb_tpu_torch.client import management
        if not args:
            for a in await management.excluded_servers(self.db):
                self._print(a)
            return
        await management.exclude_servers(self.db, args)
        self._print(f"Excluded {len(args)} server(s); the data distributor "
                    "is draining them")

    async def _cmd_include(self, args):
        from foundationdb_tpu_torch.client import management
        await management.include_servers(
            self.db, None if (not args or args == ["all"]) else args)
        self._print("Included")

    async def _cmd_coordinators(self, args):
        coords = list(getattr(self.db, "coordinators", None) or [])
        if not coords:
            status = await self.db.get_status()
            coords = status["cluster"]["coordinators"]
        self._print("Cluster coordinators: " + " ".join(coords))

    async def _cmd_writemode(self, args):
        if args and args[0] == "on":
            self.write_mode = True
        elif args and args[0] == "off":
            self.write_mode = False
        else:
            self._print("ERROR: writemode <on|off>")

    def _need_writemode(self) -> bool:
        if not self.write_mode:
            self._print("ERROR: writemode must be enabled to set or clear "
                        "keys in the database.")
            return True
        return False

    async def _cmd_get(self, args):
        key = args[0].encode()
        async def fn(tr):
            return await tr.get(key)
        v = await self.db.transact(fn)
        if v is None:
            self._print(f"`{args[0]}': not found")
        else:
            self._print(f"`{args[0]}' is `{v.decode(errors='replace')}'")

    async def _cmd_set(self, args):
        if self._need_writemode():
            return
        key, value = args[0].encode(), args[1].encode()
        async def fn(tr):
            tr.set(key, value)
        await self.db.transact(fn)
        self._print("Committed")

    async def _cmd_clear(self, args):
        if self._need_writemode():
            return
        key = args[0].encode()
        async def fn(tr):
            tr.clear(key)
        await self.db.transact(fn)
        self._print("Committed")

    async def _cmd_clearrange(self, args):
        if self._need_writemode():
            return
        b, e = args[0].encode(), args[1].encode()
        async def fn(tr):
            tr.clear_range(b, e)
        await self.db.transact(fn)
        self._print("Committed")

    async def _cmd_getrange(self, args):
        begin = args[0].encode()
        end = args[1].encode() if len(args) > 1 else b"\xff"
        limit = int(args[2]) if len(args) > 2 else 25
        async def fn(tr):
            return await tr.get_range(begin, end, limit=limit)
        rows = await self.db.transact(fn)
        self._print("Range limited to {} keys".format(limit))
        for k, v in rows:
            self._print(f"`{_fmt_key(k)}' is `{v.decode(errors='replace')}'")

    async def _cmd_status(self, args):
        status = await self.db.get_status()
        if args and args[0] == "json":
            self._print(json.dumps(status, indent=2, default=str))
            return
        c = status["cluster"]
        self._print("Cluster:")
        self._print(f"  Recovery state  - {c['recovery_state']['name']} "
                    f"(generation {c['generation']})")
        self._print(f"  Controller      - {c['cluster_controller']}")
        self._print(f"  Coordinators    - {len(c['coordinators'])}")
        self._print(f"  Workers         - {len(c['workers'])}")
        lay = c["layers"]
        self._print(f"  Proxies         - {len(lay['proxies'])}")
        self._print(f"  Resolvers       - {len(lay['resolvers'])}")
        self._print(f"  Logs            - "
                    f"{len(lay['logs'][-1]['addrs']) if lay['logs'] else 0}")
        self._print(f"  Storage servers - {len(lay['storages'])}")
        if "qos" in c:
            self._print(f"  TPS limit       - "
                        f"{c['qos'].get('transactions_per_second_limit')}")

    async def _cmd_exit(self, args):
        raise SystemExit(0)


def main():  # pragma: no cover — interactive entry point
    """Boot a sandbox cluster and run the REPL (fdbcli against a simulated
    database, for exploring the API). The resolvers take the knobs'
    backend: the device engine on the card by default; set CONFLICT_DEVICE
    to cpu (or CONFLICT_BACKEND to oracle) to run without one."""
    from foundationdb_tpu_torch.server.cluster import RecoverableCluster
    from foundationdb_tpu_torch.utils.cudaenv import resolve_device
    from foundationdb_tpu_torch.utils.knobs import KNOBS

    # no fallback: asking for the card without one refuses here
    # (platform_error), before a cluster boots
    if KNOBS.CONFLICT_BACKEND in ("device", "sharded"):
        resolve_device(KNOBS.CONFLICT_DEVICE)
    c = RecoverableCluster(seed=0)
    db = c.database()
    cli = FdbCli(c, db)

    async def boot():
        await db.refresh(max_wait=120.0)
    c.run(c.loop.spawn(boot()), max_time=600.0)
    print("fdbcli (sandbox cluster). Type `help' for help, `exit' to quit.")
    while True:
        try:
            line = input("fdb> ")
        except EOFError:
            break
        try:
            for out in cli.execute(line):
                print(out)
        except SystemExit:
            break


if __name__ == "__main__":  # pragma: no cover
    main()
