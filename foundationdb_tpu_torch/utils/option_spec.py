"""The options specification + generator (vexillographer).

Reference: fdbclient/vexillographer/fdb.options (the machine-readable spec
every binding generates its option surface from) + vexillographer/*.cs (the
generator). The names and codes below follow the PUBLIC cross-language
option numbering — like error codes and tuple type codes, they are the
compatibility contract client code depends on; the spec structure and the
generator are this framework's own.

`generate()` emits utils/fdboptions.py (checked in; the test regenerates it
and asserts stability), giving bindings one import with NetworkOption /
DatabaseOption / TransactionOption / StreamingMode enums — the same shape
vexillographer emits for the Python binding.
"""

from __future__ import annotations

# scope -> [(name, code, param_type | None, description)]
SPEC: dict[str, list[tuple[str, int, str | None, str]]] = {
    "NetworkOption": [
        ("trace_enable", 30, "String", "output directory for trace files"),
        ("trace_roll_size", 31, "Int", "max bytes per trace file"),
        ("trace_max_logs_size", 32, "Int", "max bytes of trace files kept"),
        ("trace_log_group", 33, "String", "LogGroup attribute on traces"),
        ("knob", 40, "String", "knob_name=value override"),
        ("tls_cert_path", 42, "String", "path to the certificate chain"),
        ("tls_key_path", 45, "String", "path to the private key"),
        ("tls_verify_peers", 41, "Bytes", "peer verification pattern"),
        ("tls_ca_path", 62, "String", "path to the trusted CA bundle"),
        ("disable_multi_version_client_api", 60, None, ""),
        ("external_client_library", 66, "String",
         "path to an additional client library"),
    ],
    "DatabaseOption": [
        ("location_cache_size", 10, "Int",
         "max keyserver locations cached client-side"),
        ("max_watches", 20, "Int", "max outstanding watches"),
        ("machine_id", 21, "String", "client locality machine id"),
        ("datacenter_id", 22, "String", "client locality dc id"),
        ("transaction_timeout", 500, "Int",
         "default per-transaction timeout, ms"),
        ("transaction_retry_limit", 501, "Int",
         "default per-transaction retry limit"),
        ("transaction_max_retry_delay", 502, "Int",
         "default max backoff between retries, ms"),
        ("transaction_size_limit", 503, "Int",
         "default max transaction bytes"),
    ],
    "TransactionOption": [
        ("causal_write_risky", 10, None,
         "commit may be lost on proxy failure"),
        ("causal_read_risky", 20, None,
         "read version may precede a concurrent commit"),
        ("next_write_no_write_conflict_range", 30, None,
         "the next write carries no write conflict range"),
        ("read_your_writes_disable", 51, None,
         "reads skip the uncommitted-writes overlay"),
        ("snapshot_ryw_enable", 600, None, ""),
        ("snapshot_ryw_disable", 601, None, ""),
        ("timeout", 500, "Int", "transaction timeout, ms"),
        ("retry_limit", 501, "Int", "max on_error retries"),
        ("max_retry_delay", 502, "Int", "max backoff between retries, ms"),
        ("size_limit", 503, "Int", "max transaction bytes"),
        ("access_system_keys", 301, None, "allow \\xff keyspace access"),
        ("read_system_keys", 302, None, "allow \\xff keyspace reads"),
        ("debug_transaction_identifier", 403, "String",
         "identifier for g_traceBatch txn timelines"),
        ("log_transaction", 404, None,
         "emit the txn's timeline to the trace"),
    ],
    "StreamingMode": [
        ("want_all", -2, None, "client intends to read the whole range"),
        ("iterator", -1, None, "batches sized for iteration"),
        ("exact", 0, None, "limit is the exact batch size"),
        ("small", 1, None, "small batches"),
        ("medium", 2, None, "medium batches"),
        ("large", 3, None, "large batches"),
        ("serial", 4, None, "one batch, maximum size"),
    ],
}

_HEADER = '''"""GENERATED by utils/option_spec.py — do not edit by hand.

The option surface every binding shares (the vexillographer output for this
framework): enum-like classes whose attributes carry (code, param_type).
Regenerate with `python -m foundationdb_tpu_torch.utils.option_spec`.
"""

'''


class Option:
    """One option: int-comparable code plus parameter metadata."""

    def __init__(self, name: str, code: int, param_type: str | None,
                 description: str):
        self.name = name
        self.code = code
        self.param_type = param_type
        self.description = description

    def __int__(self):
        return self.code

    def __eq__(self, other):
        return self.code == int(other)

    def __hash__(self):
        return hash(self.code)

    def __repr__(self):
        return f"<{self.name} ({self.code})>"


def generate_source() -> str:
    out = [_HEADER,
           "from foundationdb_tpu_torch.utils.option_spec import Option\n\n"]
    for scope, entries in SPEC.items():
        out.append(f"\nclass {scope}:\n")
        for name, code, ptype, desc in entries:
            out.append(f"    {name} = Option({name!r}, {code}, {ptype!r}, "
                       f"{desc!r})\n")
        out.append(f"\n\n{_snake(scope)}_by_code = {{int(v): v for v in "
                   f"{scope}.__dict__.values() if isinstance(v, Option)}}\n")
    return "".join(out)


def _snake(s: str) -> str:
    import re
    return re.sub(r"(?<!^)(?=[A-Z])", "_", s).lower()


def generate(path: str | None = None) -> str:
    import os
    if path is None:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fdboptions.py")
    src = generate_source()
    with open(path, "w") as f:
        f.write(src)
    return path


if __name__ == "__main__":
    print(generate())
