"""GENERATED by utils/option_spec.py — do not edit by hand.

The option surface every binding shares (the vexillographer output for this
framework): enum-like classes whose attributes carry (code, param_type).
Regenerate with `python -m foundationdb_tpu_torch.utils.option_spec`.
"""

from foundationdb_tpu_torch.utils.option_spec import Option


class NetworkOption:
    trace_enable = Option('trace_enable', 30, 'String', 'output directory for trace files')
    trace_roll_size = Option('trace_roll_size', 31, 'Int', 'max bytes per trace file')
    trace_max_logs_size = Option('trace_max_logs_size', 32, 'Int', 'max bytes of trace files kept')
    trace_log_group = Option('trace_log_group', 33, 'String', 'LogGroup attribute on traces')
    knob = Option('knob', 40, 'String', 'knob_name=value override')
    tls_cert_path = Option('tls_cert_path', 42, 'String', 'path to the certificate chain')
    tls_key_path = Option('tls_key_path', 45, 'String', 'path to the private key')
    tls_verify_peers = Option('tls_verify_peers', 41, 'Bytes', 'peer verification pattern')
    tls_ca_path = Option('tls_ca_path', 62, 'String', 'path to the trusted CA bundle')
    disable_multi_version_client_api = Option('disable_multi_version_client_api', 60, None, '')
    external_client_library = Option('external_client_library', 66, 'String', 'path to an additional client library')


network_option_by_code = {int(v): v for v in NetworkOption.__dict__.values() if isinstance(v, Option)}

class DatabaseOption:
    location_cache_size = Option('location_cache_size', 10, 'Int', 'max keyserver locations cached client-side')
    max_watches = Option('max_watches', 20, 'Int', 'max outstanding watches')
    machine_id = Option('machine_id', 21, 'String', 'client locality machine id')
    datacenter_id = Option('datacenter_id', 22, 'String', 'client locality dc id')
    transaction_timeout = Option('transaction_timeout', 500, 'Int', 'default per-transaction timeout, ms')
    transaction_retry_limit = Option('transaction_retry_limit', 501, 'Int', 'default per-transaction retry limit')
    transaction_max_retry_delay = Option('transaction_max_retry_delay', 502, 'Int', 'default max backoff between retries, ms')
    transaction_size_limit = Option('transaction_size_limit', 503, 'Int', 'default max transaction bytes')


database_option_by_code = {int(v): v for v in DatabaseOption.__dict__.values() if isinstance(v, Option)}

class TransactionOption:
    causal_write_risky = Option('causal_write_risky', 10, None, 'commit may be lost on proxy failure')
    causal_read_risky = Option('causal_read_risky', 20, None, 'read version may precede a concurrent commit')
    next_write_no_write_conflict_range = Option('next_write_no_write_conflict_range', 30, None, 'the next write carries no write conflict range')
    read_your_writes_disable = Option('read_your_writes_disable', 51, None, 'reads skip the uncommitted-writes overlay')
    snapshot_ryw_enable = Option('snapshot_ryw_enable', 600, None, '')
    snapshot_ryw_disable = Option('snapshot_ryw_disable', 601, None, '')
    timeout = Option('timeout', 500, 'Int', 'transaction timeout, ms')
    retry_limit = Option('retry_limit', 501, 'Int', 'max on_error retries')
    max_retry_delay = Option('max_retry_delay', 502, 'Int', 'max backoff between retries, ms')
    size_limit = Option('size_limit', 503, 'Int', 'max transaction bytes')
    access_system_keys = Option('access_system_keys', 301, None, 'allow \\xff keyspace access')
    read_system_keys = Option('read_system_keys', 302, None, 'allow \\xff keyspace reads')
    debug_transaction_identifier = Option('debug_transaction_identifier', 403, 'String', 'identifier for g_traceBatch txn timelines')
    log_transaction = Option('log_transaction', 404, None, "emit the txn's timeline to the trace")


transaction_option_by_code = {int(v): v for v in TransactionOption.__dict__.values() if isinstance(v, Option)}

class StreamingMode:
    want_all = Option('want_all', -2, None, 'client intends to read the whole range')
    iterator = Option('iterator', -1, None, 'batches sized for iteration')
    exact = Option('exact', 0, None, 'limit is the exact batch size')
    small = Option('small', 1, None, 'small batches')
    medium = Option('medium', 2, None, 'medium batches')
    large = Option('large', 3, None, 'large batches')
    serial = Option('serial', 4, None, 'one batch, maximum size')


streaming_mode_by_code = {int(v): v for v in StreamingMode.__dict__.values() if isinstance(v, Option)}
