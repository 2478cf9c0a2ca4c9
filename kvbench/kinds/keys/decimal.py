"""Keys "decimal": the prefix and the decimal FNV-1a 64 hash of the record
number (YCSB CoreWorkload.buildKeyName with its default hashed insert
order)."""

from kvbench import gen


def keys(spec, records):
    prefix = spec["prefix"].encode()
    return [b"%s%d" % (prefix, n) for n in gen.fnv64(records).tolist()]
