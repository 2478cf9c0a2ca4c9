"""fdbmonitor: the process supervisor for real deployments.

Reference: fdbmonitor/fdbmonitor.cpp:1 — a plain (non-Flow) supervisor that
reads an ini-style conf, spawns the configured fdbserver processes, restarts
any that die with exponential backoff, and reloads the conf on change
(kqueue/inotify there; polling here).

Conf format (the reference's foundationdb.conf shape, trimmed):

    [general]
    restart_delay = 5        ; base backoff seconds (doubles per crash, capped)
    restart_delay_reset = 60 ; healthy-for-this-long resets the backoff

    [server.4500]
    spec = /path/to/role-spec.json   ; passed to net.server_main

Each [server.<id>] section is one supervised `python -m
foundationdb_tpu_torch.net.server_main <spec>` process. Run:
    python -m foundationdb_tpu_torch.tools.fdbmonitor /etc/fdbtpu/monitor.conf
"""

from __future__ import annotations

import configparser
import json
import os
import signal
import subprocess
import sys
import time


class Supervised:
    def __init__(self, section: str, spec_path: str):
        self.section = section
        self.spec_path = spec_path
        self.proc: subprocess.Popen | None = None
        self.backoff = 0.0
        self.next_start = 0.0
        self.started_at = 0.0

    def args(self) -> list[str]:
        with open(self.spec_path) as f:
            spec = f.read()
        json.loads(spec)  # validate before spawning
        return [sys.executable, "-m", "foundationdb_tpu_torch.net.server_main", spec]


class FdbMonitor:
    def __init__(self, conf_path: str, out=sys.stderr):
        self.conf_path = conf_path
        self.out = out
        self.restart_delay = 5.0
        self.restart_delay_reset = 60.0
        self.children: dict[str, Supervised] = {}
        self._conf_mtime = 0.0
        self._stopping = False

    def log(self, event: str, **details):
        print(json.dumps({"Type": event, "Time": round(time.time(), 3),
                          **details}), file=self.out, flush=True)

    # -- conf (re)load: fdbmonitor.cpp load_conf --

    def load_conf(self) -> bool:
        try:
            mtime = os.stat(self.conf_path).st_mtime
        except OSError:
            return False
        if mtime == self._conf_mtime:
            return False
        try:
            cp = configparser.ConfigParser(inline_comment_prefixes=(";", "#"))
            cp.read(self.conf_path)
            if cp.has_section("general"):
                self.restart_delay = cp.getfloat(
                    "general", "restart_delay", fallback=self.restart_delay)
                self.restart_delay_reset = cp.getfloat(
                    "general", "restart_delay_reset",
                    fallback=self.restart_delay_reset)
            wanted: dict[str, str] = {}
            for section in cp.sections():
                if section.startswith("server."):
                    wanted[section] = cp.get(section, "spec")
        except (configparser.Error, ValueError) as e:
            # a conf typo must never take down the supervised processes:
            # keep the running config (and keep the old mtime, so a fixed
            # file is picked up; an unchanged broken file just re-logs)
            self.log("ConfLoadFailed", error=str(e))
            return False
        self._conf_mtime = mtime
        # stop removed/changed sections; start new ones
        for sec in list(self.children):
            if sec not in wanted or self.children[sec].spec_path != wanted[sec]:
                self.stop_child(self.children.pop(sec))
        for sec, spec in wanted.items():
            if sec not in self.children:
                self.children[sec] = Supervised(sec, spec)
        self.log("ConfLoaded", sections=sorted(self.children))
        return True

    # -- child lifecycle --

    def start_child(self, c: Supervised):
        try:
            c.proc = subprocess.Popen(
                c.args(), stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL)
            c.started_at = time.time()
            self.log("ProcessStarted", section=c.section, pid=c.proc.pid)
        except Exception as e:  # noqa: BLE001 — supervisor must survive
            self.log("ProcessStartFailed", section=c.section, error=str(e))
            self._schedule_restart(c)

    def stop_child(self, c: Supervised):
        if c.proc and c.proc.poll() is None:
            c.proc.terminate()
            try:
                c.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                c.proc.kill()
                c.proc.wait()
        self.log("ProcessStopped", section=c.section)

    def _schedule_restart(self, c: Supervised):
        # exponential backoff, reset after a healthy run
        # (fdbmonitor.cpp's current_restart_delay logic)
        if c.started_at and time.time() - c.started_at > self.restart_delay_reset:
            c.backoff = 0.0
        c.backoff = min(max(c.backoff * 2, self.restart_delay), 60.0)
        c.next_start = time.time() + c.backoff
        self.log("ProcessRestartScheduled", section=c.section,
                 delay=round(c.backoff, 1))

    def poll_once(self):
        self.load_conf()
        now = time.time()
        for c in self.children.values():
            if c.proc is None:
                if now >= c.next_start:
                    self.start_child(c)
            elif c.proc.poll() is not None:
                self.log("ProcessDied", section=c.section,
                         exit_code=c.proc.returncode)
                c.proc = None
                self._schedule_restart(c)

    def run(self, poll_interval: float = 1.0):
        self.log("MonitorStarted", conf=self.conf_path)

        def on_term(_sig, _frame):
            self._stopping = True
        signal.signal(signal.SIGTERM, on_term)
        signal.signal(signal.SIGINT, on_term)
        try:
            while not self._stopping:
                try:
                    self.poll_once()
                except Exception as e:  # noqa: BLE001 — supervisor survives
                    self.log("PollFailed", error=repr(e))
                time.sleep(poll_interval)
        finally:
            for c in self.children.values():
                self.stop_child(c)
            self.log("MonitorStopped")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("usage: python -m foundationdb_tpu_torch.tools.fdbmonitor <conf>",
              file=sys.stderr)
        return 2
    FdbMonitor(argv[0]).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
