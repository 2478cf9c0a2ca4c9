"""fdbbackup / fdbrestore: the backup operator CLI.

Reference: fdbbackup/backup.actor.cpp:1 — one binary multiplexed by argv[0]
into fdbbackup (start/status/discontinue), fdbrestore, and the agents. Here:

    python -m foundationdb_tpu_torch.tools.fdbbackup start   -d <container_dir>
    python -m foundationdb_tpu_torch.tools.fdbbackup status
    python -m foundationdb_tpu_torch.tools.fdbbackup stop    -d <container_dir>
    python -m foundationdb_tpu_torch.tools.fdbbackup restore -d <container_dir>

Commands drive a cluster through the ordinary client API. `connect()` is the
cluster-file stand-in: tests (and embedders) pass a Database; the CLI main
builds one from --cluster host:port (a proxy address) and --storage
host:port, over the real transport (net/transport.py).
"""

from __future__ import annotations

import argparse
import asyncio  # noqa: F401  (documentational: the real loop is ours)
import sys

from foundationdb_tpu_torch.backup.agent import (
    BEGIN_KEY, END_KEY, STATE_KEY, BackupAgent, RestoreAgent)
from foundationdb_tpu_torch.backup.container import DirBackupContainer


async def cmd_start(db, container_dir: str, chunks: int = 8) -> str:
    agent = BackupAgent(db, DirBackupContainer(container_dir), chunks=chunks)
    await agent.start()
    # drive the snapshot + tail the log until stop is requested elsewhere:
    # `start` here kicks the snapshot and returns (the agent loops are what
    # `backup_agent` runs; for the CLI we run one inline snapshot pass)
    await agent.run_agent()
    return "backup started; snapshot complete; log tee active"


async def cmd_status(db) -> str:
    async def body(tr):
        state = await tr.get(STATE_KEY)
        begin = await tr.get(BEGIN_KEY)
        end = await tr.get(END_KEY)
        return state, begin, end
    state, begin, end = await db.transact(body, max_retries=100)
    if state is None:
        return "no backup has ever been started"
    out = f"state: {state.decode()}"
    if begin:
        out += f"  begin_version: {int(begin)}"
    if end:
        out += f"  end_version: {int(end)}"
    return out


async def cmd_stop(db, container_dir: str) -> str:
    agent = BackupAgent(db, DirBackupContainer(container_dir))
    end_version = await agent.stop()
    return f"backup stopped; restorable at end_version {end_version}"


async def cmd_restore(db, container_dir: str) -> str:
    applied = await RestoreAgent(db, DirBackupContainer(container_dir)).restore()
    return f"restore complete; {applied} log mutations applied"


async def run_command(db, argv: list[str]) -> str:
    ap = argparse.ArgumentParser(prog="fdbbackup")
    ap.add_argument("command",
                    choices=["start", "status", "stop", "restore"])
    ap.add_argument("-d", "--destdir", help="backup container directory")
    args = ap.parse_args(argv)
    if args.command != "status" and not args.destdir:
        raise SystemExit("fdbbackup: -d <container_dir> required")
    if args.command == "start":
        return await cmd_start(db, args.destdir)
    if args.command == "status":
        return await cmd_status(db)
    if args.command == "stop":
        return await cmd_stop(db, args.destdir)
    return await cmd_restore(db, args.destdir)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    ap = argparse.ArgumentParser(prog="fdbbackup", add_help=False)
    ap.add_argument("--cluster", required=True,
                    help="proxy address host:port (cluster-file stand-in)")
    ap.add_argument("--storage", required=True,
                    help="storage address host:port for location seeding")
    known, rest = ap.parse_known_args(argv)

    from foundationdb_tpu_torch.client.database import Database, LocationCache
    from foundationdb_tpu_torch.net.transport import NetTransport, RealEventLoop
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    loop = RealEventLoop()
    client = NetTransport(loop, f"127.0.0.1:{port}")
    client.start()
    try:
        db = Database(client.process, proxies=[known.cluster],
                      locations=LocationCache([b""], [[known.storage]]))
        out = loop.run_future(loop.spawn(run_command(db, rest)),
                              max_time=600.0)
        print(out)
    finally:
        client.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
