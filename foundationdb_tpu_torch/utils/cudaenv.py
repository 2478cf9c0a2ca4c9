"""Device choice and the host<->device transfer choke points.

Counterpart of foundationdb_tpu/utils/jaxenv.py. The JAX module probes the
accelerator in a subprocess and, when none attaches, pins the process to
the CPU under a `cpu-fallback` label. The port does not: the device is what
the caller asked for, and asking for CUDA where there is none raises
`platform_error`. The CPU is used only when a caller names it (the tests
do), so no run can mistake the plain PyTorch path for the card's.

Every transfer of the conflict engine goes through `to_device` and
`to_host_async`, which count calls and bytes (merged into the resolver's
RESOLVER_METRICS, like jaxenv's `JaxTransfers`): host->device from pinned
buffers with `non_blocking`, device->host into pinned buffers with
`non_blocking`, completion marked by a CUDA event.
"""

from __future__ import annotations

import torch

from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.stats import CounterCollection


def resolve_device(name) -> torch.device:
    """torch.device for a knob value or argument ("cuda", "cuda:1", "cpu",
    or a torch.device). Raises FDBError("platform_error") for a CUDA device
    when CUDA is not available; never substitutes the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise FDBError("platform_error",
                           f"device {name!r} asked for, but CUDA is not "
                           f"available to this process")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise FDBError("invalid_option", f"unsupported device {name!r}")
    return dev


transfer_metrics = CounterCollection("CudaTransfers")
_put_count = transfer_metrics.counter("DevicePuts")
_put_bytes = transfer_metrics.counter("DevicePutBytes")
_get_count = transfer_metrics.counter("DeviceGets")
_get_bytes = transfer_metrics.counter("DeviceGetBytes")


def host_buffer(shape, dtype, device: torch.device) -> torch.Tensor:
    """A host tensor to stage transfers for `device`: pinned for CUDA (so
    copies can run asynchronously), plain memory for the CPU."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Host tensor -> device. From a pinned buffer the copy is enqueued on
    the current stream and returns at once; the caller keeps the buffer
    unchanged until an event recorded after this call has completed. On the
    CPU it is the tensor itself."""
    if device.type == "cpu":
        return t
    _put_count.increment()
    _put_bytes.increment(t.numel() * t.element_size())
    return t.to(device, non_blocking=True)


def to_host_async(t: torch.Tensor):
    """Device tensor -> (pinned host tensor, event or None). The copy is
    enqueued; the host values are valid once the event has completed (None
    on the CPU, where they are valid at once)."""
    if t.device.type == "cpu":
        return t, None
    _get_count.increment()
    _get_bytes.increment(t.numel() * t.element_size())
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return out, ev
