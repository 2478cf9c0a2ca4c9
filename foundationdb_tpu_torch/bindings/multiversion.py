"""MultiVersion client: pick the client library that speaks the cluster's
protocol.

Reference: fdbclient/MultiVersionTransaction.actor.cpp (MultiVersionApi) —
the production client loads SEVERAL client libraries (the local one plus
`external_client_library` options), selects the one whose protocol matches
the connected cluster, and transparently re-targets databases when the
cluster upgrades. Here a "client library" is any module exposing the
C-ABI-shaped surface of bindings/fdb_c.py (select/get_max_api_version,
setup/run/stop network, fdb_create_database); the loader keeps the same
selection rules:

  - fdb_select_api_version(v) fails if NO registered client supports v;
  - the ACTIVE client is the lowest-max-version client still supporting the
    requested version (prefer the most compatible library, reference
    MultiVersionApi::selectApiVersion);
  - disable_multi_version_client_api pins the local client;
  - every surface call delegates to the active client, so application code
    is identical with one or many libraries.
"""

from __future__ import annotations

from foundationdb_tpu_torch.utils.errors import error_code


class MultiVersionApi:
    def __init__(self):
        from foundationdb_tpu_torch.bindings import fdb_c
        self._clients: dict[str, object] = {"local": fdb_c}
        self._active = fdb_c
        self._selected: int | None = None
        self._multi_version_disabled = False

    # -- library management (NetworkOption external_client_library) --

    def add_external_client(self, name: str, module) -> int:
        """Register another client library (a module with the fdb_c
        surface). Must happen before version selection, like the option."""
        if self._selected is not None:
            return error_code("client_invalid_operation")
        for attr in ("fdb_get_max_api_version", "fdb_select_api_version",
                     "fdb_create_database"):
            if not hasattr(module, attr):
                return error_code("invalid_option_value")
        self._clients[name] = module
        return 0

    def disable_multi_version_client_api(self) -> int:
        if self._selected is not None:
            return error_code("client_invalid_operation")
        self._multi_version_disabled = True
        return 0

    @property
    def active_client(self):
        return self._active

    # -- the selection rule --

    def fdb_select_api_version(self, version: int) -> int:
        if self._selected is not None and self._selected != version:
            return error_code("client_invalid_operation")
        pool = ({"local": self._clients["local"]}
                if self._multi_version_disabled else self._clients)
        candidates = [(m.fdb_get_max_api_version(), name, m)
                      for name, m in pool.items()
                      if m.fdb_get_max_api_version() >= version]
        if not candidates:
            return error_code("client_invalid_operation")  # api_version_not_supported
        # most-compatible first: the SMALLEST max version still covering the
        # request (a newer library may drop legacy behaviors)
        candidates.sort()
        _max, _name, client = candidates[0]
        err = client.fdb_select_api_version(version)
        if err:
            return err
        self._active = client
        self._selected = version
        return 0

    # -- surface delegation --

    def __getattr__(self, name: str):
        if name.startswith("fdb_"):
            return getattr(self._active, name)
        raise AttributeError(name)
