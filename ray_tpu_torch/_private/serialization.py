"""Serialization: the runtime's pickler, and the typed `torch.Tensor` wire
(protocol-5 pickling with out-of-band buffers).

The port's counterpart of `ray_tpu/_private/serialization.py`, both halves:

- The runtime's half (the context stack, `_DataPlanePickler`, `serialize`,
  `deserialize_with_refs`, `note_object_ref`, `dumps_function` /
  `loads_function`): cloudpickle with out-of-band buffers, so large numpy
  arrays and tensors round-trip without copies, plus discovery of the
  ObjectRefs nested in a value (for borrowing and reference counting). Its
  pickler carries the typed tensor reducer itself, so the port's runtime
  sends every tensor typed with no `install_tensor_wire()` call.
- The typed wire. A tensor travels as a small in-band header (dtype, shape,
  requires_grad, device, whether it is a Parameter) and one raw byte view
  of its values as an out-of-band `pickle.PickleBuffer`, where torch's own
  pickling writes the storage into the pickle stream (a full copy) and a
  CUDA tensor's receiver needs CUDA to load it. `SerializedObject.write_into`
  then makes the one host copy into the destination (an object-store
  arena), and a get rebuilds the tensor as a view over the received buffer
  (CPU) or with one host-to-device copy (CUDA): from the store's shared
  arena at the pinned rate, the windows of its mapping that the object
  spans registered with CUDA once per process (`pinned_pages.pin_range`).

`deserialize` is the inverse of `serialize` for a value alone. The JAX
package's runtime (cloudpickle's pickler, inside `ray_tpu`) picks the wire
up through `install_tensor_wire`, which registers the reducer in
cloudpickle's own class-level dispatch table; the port imports nothing of
that runtime. A tensor received outside the port's runtime installs it.
`COPY_STATS` counts the typed reductions and rebuilds, the payload
flattens, which the data plane forbids on its hot path, and the CUDA gets
that took the pageable route.

torch is imported where a tensor is reduced or rebuilt, not with this
module: a runtime worker that handles no tensor never loads it.
"""

from __future__ import annotations

import io
import pickle
import threading
import warnings
from typing import Any, List, Optional, Tuple

import cloudpickle

_thread_local = threading.local()

# Copy accounting: payload_flatten counts whole-payload materializations
# (to_bytes); typed_tensor_put/get count the typed wire's reductions and
# rebuilds; typed_tensor_get_pageable the CUDA rebuilds whose host buffer
# was neither pinned nor in shared memory that pinned_pages registers,
# copied through the driver's pageable route. Plain int bumps, read by tests and
# the bench only.
COPY_STATS = {
    "payload_flatten": 0,
    "typed_tensor_put": 0,
    "typed_tensor_get": 0,
    "typed_tensor_get_pageable": 0,
}

# Whether install_tensor_wire has run in this process: None not yet (or
# uninstalled since), True installed, False without cloudpickle. A get
# installs the wire only while it is None, so it tries the import once.
_installed: Optional[bool] = None


def _get_ctx_stack():
    if not hasattr(_thread_local, "ref_stack"):
        _thread_local.ref_stack = []
    return _thread_local.ref_stack


class SerializedObject:
    """A serialized payload: a pickle5 stream plus out-of-band buffers, and
    the ObjectRefs found nested in the value (`serialize`)."""

    __slots__ = ("inband", "buffers", "contained_refs", "_wire_cache")

    def __init__(self, inband: bytes, buffers: List[pickle.PickleBuffer],
                 contained_refs=()):
        self.inband = inband
        self.buffers = buffers
        self.contained_refs = list(contained_refs)
        self._wire_cache = None

    def __reduce__(self):
        # Wire format: drop contained_refs (metadata, carried separately in
        # TaskArg.nested_ids) so that transporting a serialized payload never
        # re-instantiates live ObjectRefs mid-frame-decode — doing so would
        # trigger borrow registration on the RPC loop thread (deadlock).
        # The buffers ride as PickleBuffer objects: under the RPC layer's
        # protocol-5 out-of-band framing they go to the socket as raw
        # scatter segments (zero copies); a pickler without a
        # buffer_callback still serializes them in-band (a copy, but only
        # on cold paths like KV snapshots — never the data plane).
        return (_rebuild_serialized, (self.inband, list(self.buffers)))

    def total_bytes(self) -> int:
        return len(self.inband) + sum(b.raw().nbytes for b in self.buffers)

    def _wire_parts(self):
        # Cached: wire_size() then write_into() would otherwise pickle the
        # header twice; the payload does not change after creation.
        if self._wire_cache is None:
            raw_buffers = [b.raw() for b in self.buffers]
            header = pickle.dumps(
                (len(self.inband), [m.nbytes for m in raw_buffers]),
                protocol=5)
            self._wire_cache = (header, raw_buffers)
        return self._wire_cache

    def wire_size(self) -> int:
        """Size of the flat wire format that to_bytes/write_into produce."""
        header, raw_buffers = self._wire_parts()
        return 4 + len(header) + len(self.inband) + sum(
            m.nbytes for m in raw_buffers)

    def write_into(self, view: memoryview) -> int:
        """Write the flat wire format into a writable buffer of at least
        wire_size() bytes (e.g. an arena): one copy, no intermediate bytes.
        -> bytes written."""
        header, raw_buffers = self._wire_parts()
        off = 0
        view[off:off + 4] = len(header).to_bytes(4, "little")
        off += 4
        view[off:off + len(header)] = header
        off += len(header)
        view[off:off + len(self.inband)] = self.inband
        off += len(self.inband)
        for m in raw_buffers:
            view[off:off + m.nbytes] = m  # raw() is 1-D contiguous 'B'
            off += m.nbytes
        return off

    def wire_segments(self) -> List:
        """The flat wire format as an ordered list of buffer segments (no
        concatenation): a chunk server slices [off, len) ranges of an
        object held in the memory store without flattening it per chunk."""
        header, raw_buffers = self._wire_parts()
        return [len(header).to_bytes(4, "little"), header,
                memoryview(self.inband), *raw_buffers]

    def to_bytes(self) -> bytes:
        """Flatten to one contiguous bytes object (copies every buffer): not
        for the data plane, which writes with write_into."""
        COPY_STATS["payload_flatten"] += 1
        out = io.BytesIO()
        header, raw_buffers = self._wire_parts()
        out.write(len(header).to_bytes(4, "little"))
        out.write(header)
        out.write(self.inband)
        for m in raw_buffers:
            out.write(m)
        return out.getvalue()

    @classmethod
    def from_bytes(cls, data) -> "SerializedObject":
        """The inverse of to_bytes/write_into; the buffers are views of
        `data`, not copies."""
        view = memoryview(data)
        hlen = int.from_bytes(view[:4], "little")
        inband_len, buf_lens = pickle.loads(view[4:4 + hlen])
        off = 4 + hlen
        inband = bytes(view[off:off + inband_len])
        off += inband_len
        buffers = []
        for n in buf_lens:
            buffers.append(pickle.PickleBuffer(view[off:off + n]))
            off += n
        return cls(inband, buffers)


def _rebuild_serialized(inband: bytes, raw_buffers) -> "SerializedObject":
    return SerializedObject(inband,
                            [pickle.PickleBuffer(b) for b in raw_buffers])


class _TensorPickler(pickle.Pickler):
    """pickle.Pickler with the typed tensor reducer. reducer_override runs
    for almost every object, so the tensor probe is gated on the type's
    module name ("torch...") before any isinstance work."""

    def reducer_override(self, obj):
        mod = getattr(type(obj), "__module__", None)
        if mod is not None and mod.startswith("torch"):
            r = _maybe_reduce_tensor(obj)
            if r is not None:
                return r
        return NotImplemented


class _DataPlanePickler(cloudpickle.Pickler):
    """cloudpickle with the typed tensor reducer layered on top: the
    runtime's pickler. reducer_override runs for every object, so the
    tensor probe is gated on the type's module name ("torch...") before any
    isinstance work, as in _TensorPickler."""

    def reducer_override(self, obj):
        mod = getattr(type(obj), "__module__", None)
        if mod is not None and mod.startswith("torch"):
            r = _maybe_reduce_tensor(obj)
            if r is not None:
                return r
        return super().reducer_override(obj)


def serialize(value: Any) -> SerializedObject:
    """Pickle `value` (protocol 5, cloudpickle) with tensors on the typed
    wire, every PickleBuffer out of band, and the ObjectRefs nested in it
    collected into `contained_refs`."""
    buffers: List[pickle.PickleBuffer] = []
    contained: list = []
    stack = _get_ctx_stack()
    stack.append(contained)
    try:
        sink = io.BytesIO()
        _DataPlanePickler(sink, protocol=5,
                          buffer_callback=buffers.append).dump(value)
    finally:
        stack.pop()
    return SerializedObject(sink.getvalue(), buffers, contained)


def deserialize(obj: SerializedObject) -> Any:
    """The value of `obj`. A tensor received here, outside the port's
    runtime, installs the typed wire (`_rebuild_tensor`)."""
    return pickle.loads(obj.inband, buffers=obj.buffers)


def deserialize_with_refs(obj: SerializedObject) -> Tuple[Any, list]:
    """The runtime's get: -> (value, the ObjectRefs noted while loading)."""
    contained: list = []
    stack = _get_ctx_stack()
    stack.append(contained)
    try:
        value = pickle.loads(obj.inband, buffers=obj.buffers)
    finally:
        stack.pop()
    return value, contained


def note_object_ref(ref) -> None:
    """Called from ObjectRef.__reduce__ to record nesting."""
    stack = _get_ctx_stack()
    if stack:
        stack[-1].append(ref)


def dumps_function(fn) -> bytes:
    return cloudpickle.dumps(fn)


def loads_function(data: bytes):
    return pickle.loads(data)


# -- the typed tensor wire ----------------------------------------------------
#
# Wire shape: (_rebuild_tensor, (meta, PickleBuffer)) where meta is
#   (dtype name, shape, requires_grad, (device type, device index), kind)
# and kind is "tensor" or "parameter". The buffer is the tensor's values as
# one flat uint8 view of host memory: the tensor itself on the CPU, one
# device-to-host copy into pinned memory for a CUDA tensor.


def _is_dtensor(obj) -> bool:
    return type(obj).__name__ == "DTensor" and type(obj).__module__.startswith(
        "torch.distributed.tensor")


def _maybe_reduce_tensor(obj):
    """The typed reducer: a torch.Tensor or Parameter -> (_rebuild_tensor,
    (meta, PickleBuffer)); None for what torch's own reduce should handle
    (other tensor subclasses; sparse, quantized, nested and meta tensors;
    devices other than the CPU and CUDA).

    The payload is one raw byte view with no copy for a contiguous CPU
    tensor (bf16 and other dtypes numpy lacks included); one contiguous()
    copy for a non-contiguous tensor or one with its conj or neg bit set;
    one device-to-host copy for a CUDA tensor, finished before the buffer
    is handed on. A DTensor on a mesh of more than one rank raises
    TypeError: this rank holds only its own shards, and a typed wire of
    them would drop the rest. On a one-rank mesh its local tensor is the
    whole tensor and travels as a plain tensor."""
    if _is_dtensor(obj):
        if obj.device_mesh.size() > 1:
            raise TypeError(
                f"cannot serialize a DTensor on a mesh of "
                f"{obj.device_mesh.size()} ranks: a rank holds only its own "
                "shards; gather it (full_tensor()) or send to_local() "
                "explicitly")
        obj = obj.to_local()
    import torch

    kind = {torch.Tensor: "tensor", torch.nn.Parameter: "parameter"}.get(
        type(obj))
    if (kind is None or obj.layout != torch.strided or obj.is_nested
            or obj.is_quantized or obj.device.type not in ("cpu", "cuda")):
        return None
    t = obj.detach()
    if t.is_conj() or t.is_neg():
        t = t.resolve_conj().resolve_neg()
    t = t.contiguous()
    if t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        # The copy runs on t's current stream: wait for it before the
        # buffer can be read.
        torch.cuda.current_stream(t.device).synchronize()
        t = host
    COPY_STATS["typed_tensor_put"] += 1
    meta = (str(obj.dtype).removeprefix("torch."), tuple(obj.shape),
            bool(obj.requires_grad), (obj.device.type, obj.device.index),
            kind)
    return (_rebuild_tensor,
            (meta, pickle.PickleBuffer(t.reshape(-1).view(torch.uint8)
                                       .numpy())))


def _target_device(dev_type: str, index: Optional[int]):
    """Where a received tensor goes: the CPU for a CPU tensor; for a CUDA
    tensor cuda:<index> when this process has it, else this process's
    default device (its current card, or the CPU without CUDA)."""
    import torch

    if dev_type != "cuda" or not torch.cuda.is_available():
        return torch.device("cpu")
    if index is not None and index < torch.cuda.device_count():
        return torch.device("cuda", index)
    return torch.device("cuda", torch.cuda.current_device())


def _rebuild_tensor(meta, buf):
    """The inverse of _maybe_reduce_tensor, over the received buffer.

    On the CPU the tensor is a zero-copy view of `buf`. Where `buf` is
    read-only memory (an arena page, a bytes frame) so is the tensor, though
    torch cannot mark it so: writing to it is undefined, clone() it first.
    torch's warning about non-writable buffers is not emitted. A CUDA
    tensor is copied to its device (see _target_device, _to_card); the
    copy has finished when this returns, since the host view may die (and
    an arena slot be reused) right after.

    Rebuilding outside the port's runtime (`deserialize_with_refs`)
    installs the wire (install_tensor_wire): a process that has received a
    typed tensor through the JAX package's runtime sends typed tensors.
    The port's runtime needs no install and leaves cloudpickle as it is."""
    import torch

    if _installed is None and not _get_ctx_stack():
        install_tensor_wire()
    COPY_STATS["typed_tensor_get"] += 1
    dtype_name, shape, requires_grad, (dev_type, index), kind = meta
    dtype = getattr(torch, dtype_name)
    raw = memoryview(buf).cast("B")
    if raw.nbytes == 0:
        t = torch.empty(shape, dtype=dtype)
    elif raw.readonly:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            t = torch.frombuffer(raw, dtype=torch.uint8)
        t = t.view(dtype).view(shape)
    else:
        t = torch.frombuffer(raw, dtype=torch.uint8).view(dtype).view(shape)
    target = _target_device(dev_type, index)
    if target.type == "cuda":
        exporter = raw.obj
        while isinstance(exporter, memoryview):  # views of views
            exporter = exporter.obj
        t = _to_card(t, target, exporter)
    if kind == "parameter":
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad) if requires_grad else t


def _to_card(t, target, exporter=None):
    """t, a CPU view of the received buffer (exported by `exporter`),
    copied onto the card `target` and finished. From shared memory whose
    windows `pinned_pages.pin_range` registers (the object store's arena),
    or from pinned memory, the copy runs at the pinned rate; from any
    other memory it takes the driver's pageable route and is counted as
    typed_tensor_get_pageable. The process's mappings are read only for a
    buffer in none that it has registered a window of, not pinned, and not
    a bytes frame or a bytearray (which the heap holds)."""
    import torch

    from ray_tpu_torch._private import pinned_pages

    if t.numel() == 0:
        return torch.empty(t.shape, dtype=t.dtype, device=target)
    dst = torch.empty(t.shape, dtype=t.dtype, device=target)
    addr, n = t.data_ptr(), t.nbytes
    # A registered window reads as pinned too: its spans come first, since
    # a copy may not cross from one window's registration to the next.
    spans = pinned_pages.pin_range(addr, n, find=False)
    if spans is None and t.is_pinned():
        spans = [(addr, addr + n)]
    if spans is None and not isinstance(exporter, (bytes, bytearray)):
        spans = pinned_pages.pin_range(addr, n)
    if spans is not None:
        return pinned_pages.copy_pinned(dst, t, spans)
    COPY_STATS["typed_tensor_get_pageable"] += 1
    return dst.copy_(t)


def _dispatch_reduce(obj):
    """A dispatch-table entry: the typed reduce, else torch's own."""
    r = _maybe_reduce_tensor(obj)
    return r if r is not None else obj.__reduce_ex__(pickle.DEFAULT_PROTOCOL)


def _wire_types():
    import torch

    types = [torch.Tensor, torch.nn.Parameter]
    if torch.distributed.is_available():
        from torch.distributed.tensor import DTensor

        types.append(DTensor)
    return types


def install_tensor_wire() -> bool:
    """Put the typed reducer in cloudpickle's class-level dispatch table
    (the first map of `cloudpickle.Pickler.dispatch_table`), so the
    runtime's pickler sends tensors on the typed wire. The table is keyed by
    exact type: torch.Tensor, torch.nn.Parameter and DTensor (which the
    reducer refuses on a mesh of more than one rank) are registered.

    Not `copyreg.dispatch_table`: that would change what `torch.save` writes,
    and `torch.load(weights_only=True)` would refuse the result.
    Idempotent. -> False, and nothing installed, where cloudpickle is not
    importable."""
    global _installed
    try:
        import cloudpickle
    except ImportError:
        _installed = False
        return False
    table = cloudpickle.Pickler.dispatch_table.maps[0]
    for cls in _wire_types():
        table[cls] = _dispatch_reduce
    _installed = True
    return True


def uninstall_tensor_wire() -> None:
    """Remove what install_tensor_wire registered."""
    global _installed
    _installed = None
    try:
        import cloudpickle
    except ImportError:
        return
    table = cloudpickle.Pickler.dispatch_table.maps[0]
    for cls in _wire_types():
        if table.get(cls) is _dispatch_reduce:
            del table[cls]
