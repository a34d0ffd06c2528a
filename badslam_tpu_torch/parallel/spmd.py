"""Single-controller SPMD over a mesh of torch devices.

The port's counterpart of ``jax.sharding.Mesh``, ``jax.shard_map`` and the
collectives ``jax.lax.psum``, ``pmax`` and ``axis_index`` that
``badslam_tpu/parallel/sharded_ba.py`` and the mesh mode of ``DirectBA``
use. One Python process drives every device, as in JAX:

  * ``Mesh(devices, axis_names)`` is an array of ``torch.device`` shaped by
    its named axes, ``("surfels",)`` or ``("kf", "surfels")``. Entries may
    repeat: N positions on one device make a virtual mesh, which runs the
    program of N devices (on the CPU in the tests, on one card in
    ``chip_smoke.py``).
  * A ``Sharded`` tensor is a global tensor split along its leading axis
    over one mesh axis, held as one piece per mesh position; positions that
    differ only along the other axes hold the same rows. On a one-device
    mesh the pieces of a split tensor are views of it, with no copy.
  * ``shard_map(fn, mesh, in_specs, out_specs)`` runs ``fn`` once per mesh
    position, each in its own thread (as ``torch.nn.parallel.
    parallel_apply`` does), on that position's pieces of the sharded inputs
    and on its device's replica of the replicated ones, and joins the
    outputs by ``out_specs``.
  * Inside ``fn``, ``psum`` and ``pmax`` meet the other threads of the group
    along the named axes. The partials are reduced in mesh order on the
    group's first device and handed back, copied to each member's device.
    Every member's control flow, which reads only such results, takes the
    same turns.
  * One worker runs at a time: a baton starts at mesh position 0 and passes
    in mesh order at every collective and return. The workers launch from
    Python, and N threads that all want the interpreter lock hand it over
    at every launch (measured on an H100 host: a sharded BA step at 8
    shards 40x the one-device step, against 8x the launches); holding the
    baton between collectives, one thread launches at a time at the
    one-thread rate. The order is fixed, so two runs give the same bits,
    and the device work of a multi-card mesh still overlaps, since a
    launch does not wait for the card.

Streams. A worker thread starts on the default stream of its device, so each
one enters, for every device of the mesh, the stream that was current on the
calling thread. All work on one device, that of every shard and of the
collectives, then stays on one stream in issue order, and a collective needs
no event: on a virtual mesh over one card everything is one stream, and
across cards PyTorch orders a copy behind the current streams of both
devices.

Failures. Each call has its own baton and collectives. A worker that
raises ends the call: the others leave their collectives with
``SpmdAbort``, and the first real error is raised again on the calling
thread, so a failed shard cannot hang the run. A worker that waits longer
than ``TIMEOUT_SECONDS`` for its turn ends it the same way, and so do
programs that diverge (every worker waiting on a collective that cannot
complete).

A collective's result is shared by the members on the root's device: it is
never written in place.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any, Callable, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

# How long a worker waits for its turn before it ends the call.
TIMEOUT_SECONDS = 600.0


def _normalized(device) -> torch.device:
  device = torch.device(device)
  if device.type == "cuda" and device.index is None:
    return torch.device("cuda", torch.cuda.current_device())
  return device


class Mesh:
  """Devices arranged by named axes (``jax.sharding.Mesh``)."""

  def __init__(self, devices, axis_names: Sequence[str]):
    shaped = np.asarray(devices, dtype=object)
    self.devices = np.empty(shaped.shape, dtype=object)
    for i, d in enumerate(shaped.ravel()):
      self.devices.flat[i] = _normalized(d)
    self.axis_names = tuple(axis_names)
    if len(self.axis_names) != self.devices.ndim:
      raise ValueError(f"{len(self.axis_names)} axis names for a "
                       f"{self.devices.ndim}-d device array")

  @property
  def shape(self) -> Dict[str, int]:
    """Axis name -> size, in axis order."""
    return dict(zip(self.axis_names, self.devices.shape))

  @property
  def size(self) -> int:
    return int(self.devices.size)

  @property
  def first_device(self) -> torch.device:
    return self.devices.flat[0]

  def distinct_devices(self) -> List[torch.device]:
    out: List[torch.device] = []
    for d in self.devices.flat:
      if d not in out:
        out.append(d)
    return out

  def positions(self) -> List[Tuple[int, ...]]:
    return list(np.ndindex(self.devices.shape))

  def dim(self, axis: str) -> int:
    return self.axis_names.index(axis)

  def __repr__(self):
    return (f"Mesh({dict(self.shape)}, devices="
            f"{[str(d) for d in self.devices.flat]})")


class P(tuple):
  """A partition spec (``jax.sharding.PartitionSpec``): ``P()`` is
  replicated, ``P(axis)`` splits the leading dimension over mesh axis
  ``axis``."""

  def __new__(cls, *axes):
    if len(axes) > 1:
      raise ValueError("only the leading dimension is sharded")
    return super().__new__(cls, axes)

  @property
  def axis(self):
    return self[0] if self else None


class Sharded:
  """A global tensor split along its leading dimension over one mesh axis:
  ``pieces`` holds each mesh position's piece, on that position's
  device."""

  def __init__(self, mesh: Mesh, axis: str, pieces: np.ndarray):
    self.mesh = mesh
    self.axis = axis
    self.pieces = pieces

  def piece(self, index: int) -> torch.Tensor:
    """The ``index``-th block of rows (at position 0 of the other axes)."""
    pos = [0] * self.mesh.devices.ndim
    pos[self.mesh.dim(self.axis)] = index
    return self.pieces[tuple(pos)]

  def blocks(self) -> List[torch.Tensor]:
    return [self.piece(i) for i in range(self.mesh.shape[self.axis])]

  @property
  def shape(self) -> torch.Size:
    blocks = self.blocks()
    rows = sum(b.shape[0] for b in blocks)
    return torch.Size((rows,) + tuple(blocks[0].shape[1:]))

  @property
  def dtype(self) -> torch.dtype:
    return self.piece(0).dtype

  @property
  def device(self) -> torch.device:
    return self.mesh.first_device

  @property
  def nbytes(self) -> int:
    return sum(b.numel() * b.element_size() for b in self.blocks())

  def gather(self) -> torch.Tensor:
    """The global tensor on the mesh's first device."""
    dev = self.mesh.first_device
    return torch.cat([b.to(dev) for b in self.blocks()])

  def __array__(self, dtype=None, copy=None):
    a = self.gather().cpu().numpy()
    return a if dtype is None else a.astype(dtype)

  def __repr__(self):
    return (f"Sharded({tuple(self.shape)}, {self.dtype}, axis={self.axis!r},"
            f" {self.mesh})")


# --- trees: NamedTuples, tuples and lists of leaves ---


def _is_namedtuple(x) -> bool:
  return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(f: Callable, tree):
  """``f`` applied to every leaf (a tensor, a ``Sharded``, or anything that
  is not a container)."""
  if _is_namedtuple(tree):
    return type(tree)(*(tree_map(f, x) for x in tree))
  if isinstance(tree, (tuple, list)):
    return type(tree)(tree_map(f, x) for x in tree)
  return f(tree)


def _map_spec(f: Callable, tree, spec):
  """``f(leaf, spec)`` over ``tree``; a ``P`` applies to the whole subtree."""
  if isinstance(spec, P):
    return tree_map(lambda leaf: f(leaf, spec), tree)
  if _is_namedtuple(tree):
    return type(tree)(*(_map_spec(f, t, s) for t, s in zip(tree, spec)))
  if isinstance(tree, (tuple, list)):
    if len(tree) != len(spec):
      raise ValueError(f"spec {spec} does not match {len(tree)} entries")
    return type(tree)(_map_spec(f, t, s) for t, s in zip(tree, spec))
  raise TypeError(f"spec {spec!r} for a leaf of type {type(tree)}")


def gather(x):
  """A ``Sharded`` as one tensor on its mesh's first device; anything else
  as it is."""
  return x.gather() if isinstance(x, Sharded) else x


def gather_tree(tree):
  return tree_map(gather, tree)


# --- replicas ---

_replica_lock = threading.RLock()
# id(tensor) -> (weak reference, version, {device: copy})
_replicas: Dict[int, tuple] = {}


def _drop_replicas(key: int):
  with _replica_lock:
    entry = _replicas.get(key)
    if entry is not None and entry[0]() is None:
      del _replicas[key]


def replicate(x, device: torch.device):
  """``x`` on ``device``: ``x`` itself where it lies there already,
  otherwise one copy per device, kept while ``x`` lives and made again
  after ``x`` was written in place (its version counter moved) unless the
  writer reported the rows it wrote (``rows_written``)."""
  if not isinstance(x, torch.Tensor) or x.device == device:
    return x
  key = id(x)
  with _replica_lock:
    entry = _replicas.get(key)
    if entry is None or entry[0]() is not x or entry[1] != x._version:
      entry = (weakref.ref(x, lambda _, k=key: _drop_replicas(k)),
               x._version, {})
      _replicas[key] = entry
    copy = entry[2].get(device)
    if copy is None:
      copy = x.to(device, non_blocking=True)
      entry[2][device] = copy
      _count_replica_bytes(copy)
  return copy


def rows_written(x: torch.Tensor, index: int):
  """Report that row ``index`` of ``x``, and nothing else, was written in
  place since the replicas of ``x`` were last brought up to date: each
  replica takes a copy of that row only, and ``x``'s new version is
  recorded, so that the next ``replicate`` copies nothing. (A keyframe
  added to the image stacks moves one slot of ~7.1 MB at 640x480, not the
  whole stack.)"""
  with _replica_lock:
    entry = _replicas.get(id(x))
    if entry is None or entry[0]() is not x:
      return
    for device, copy in entry[2].items():
      copy[index] = x[index].to(device, non_blocking=True)
      _count_replica_bytes(copy[index])
    _replicas[id(x)] = (entry[0], x._version, entry[2])


def _split(x: torch.Tensor, mesh: Mesh, axis: str) -> List[torch.Tensor]:
  n = mesh.shape[axis]
  if x.dim() == 0 or x.shape[0] % n:
    raise ValueError(f"leading dimension of {tuple(x.shape)} does not "
                     f"divide over mesh axis {axis!r} of size {n}")
  return list(x.split(x.shape[0] // n))


def shard(x: torch.Tensor, mesh: Mesh, axis: str) -> Sharded:
  """``x`` split along its leading dimension over mesh axis ``axis``."""
  blocks = _split(x, mesh, axis)
  d = mesh.dim(axis)
  pieces = np.empty(mesh.devices.shape, dtype=object)
  for pos in mesh.positions():
    pieces[pos] = replicate(blocks[pos[d]], mesh.devices[pos])
  return Sharded(mesh, axis, pieces)


# --- collectives ---

_stats_lock = threading.Lock()
_stats = {"collectives": 0, "bytes": 0, "replica_bytes": 0}


def collective_stats() -> Dict[str, int]:
  """Since the last reset: the collectives reduced, the bytes of the
  partials they reduced, and the bytes copied to other devices to make or
  update replicas."""
  with _stats_lock:
    return dict(_stats)


def reset_collective_stats():
  with _stats_lock:
    _stats.update(collectives=0, bytes=0, replica_bytes=0)


def _count_replica_bytes(copy: torch.Tensor):
  with _stats_lock:
    _stats["replica_bytes"] += copy.numel() * copy.element_size()


class _Collective:
  """One collective of one group: the members' partials by member index,
  and the result once the last member arrived."""

  def __init__(self, size: int):
    self.slots: List[Any] = [None] * size
    self.arrived = 0
    self.read = 0
    self.result = None
    self.complete = False


class SpmdAbort(RuntimeError):
  """Raised in the workers of a call that failed elsewhere."""


class _Call:
  """What the workers of one ``shard_map`` call share. One worker runs at
  a time: the baton starts at mesh position 0 and passes, in mesh order,
  to the next worker that is not done whenever the holder meets a
  collective or returns. A worker at a collective waits until it holds the
  baton and its collective is complete."""

  def __init__(self, mesh: Mesh):
    self.mesh = mesh
    self.cond = threading.Condition()
    self.turn = 0
    self.done = [False] * mesh.size
    # Increments whenever a worker goes on running: a baton that comes
    # back to a waiting worker with no progress in between means that
    # every worker waits on a collective that cannot complete.
    self.progress = 0
    self.error: BaseException = None
    # (reduced dims, coordinates along the others, sequence) -> collective
    self._collectives: Dict[tuple, _Collective] = {}
    self._counts: Dict[tuple, int] = {}

  def _wait_turn(self, index: int):
    while self.turn != index and self.error is None:
      if not self.cond.wait(TIMEOUT_SECONDS):
        self.fail(TimeoutError(f"mesh position {index} waited "
                               f"{TIMEOUT_SECONDS} s for its turn"))
    if self.error is not None:
      raise SpmdAbort("another mesh position failed") from self.error

  def _pass(self, index: int):
    n = len(self.done)
    for k in range(1, n + 1):
      j = (index + k) % n
      if not self.done[j]:
        self.turn = j
        break
    self.cond.notify_all()

  def start(self, index: int):
    with self.cond:
      self._wait_turn(index)
      self.progress += 1

  def finish(self, index: int):
    with self.cond:
      self.done[index] = True
      if self.turn == index:
        self._pass(index)

  def fail(self, error: BaseException):
    """Ends the call: every waiting worker raises ``SpmdAbort``."""
    if self.error is None:
      self.error = error
    self.cond.notify_all()

  def collective(self, index: int, dims: Tuple[int, ...],
                 pos: Tuple[int, ...], value, reduce):
    """Deposit ``value``, run the others until the group's collective is
    complete, and return its result (``reduce`` of the partials in member
    order, made by the last member to arrive)."""
    shape = self.mesh.devices.shape
    group = (dims, tuple(c for d, c in enumerate(pos) if d not in dims))
    sizes = tuple(shape[d] for d in dims)
    member = int(np.ravel_multi_index(tuple(pos[d] for d in dims), sizes))
    size = int(np.prod(sizes))
    with self.cond:
      counter = (group, member)
      seq = self._counts.get(counter, 0)
      self._counts[counter] = seq + 1
      key = group + (seq,)
      c = self._collectives.get(key)
      if c is None:
        c = self._collectives[key] = _Collective(size)
      c.slots[member] = value
      c.arrived += 1
      if c.arrived == size:
        c.result = reduce(c.slots)
        c.slots = None
        c.complete = True
      while not c.complete:
        seen = self.progress
        self._pass(index)
        self._wait_turn(index)
        if not c.complete and self.progress == seen:
          self.fail(RuntimeError(
              "every mesh position waits on a collective that cannot "
              "complete (the positions' programs diverged)"))
          self._wait_turn(index)
      self.progress += 1
      c.read += 1
      if c.read == size:
        del self._collectives[key]
      return c.result


class _Frame(NamedTuple):
  call: _Call
  index: int
  position: Tuple[int, ...]
  device: torch.device


_local = threading.local()


def _frame() -> _Frame:
  frame = getattr(_local, "frame", None)
  if frame is None:
    raise RuntimeError("a collective outside shard_map")
  return frame


def current_device():
  """The device of the calling worker's mesh position (None outside
  ``shard_map``)."""
  frame = getattr(_local, "frame", None)
  return None if frame is None else frame.device


def axis_index(axis: str) -> int:
  """The calling worker's coordinate along ``axis``."""
  frame = _frame()
  return frame.position[frame.call.mesh.dim(axis)]


def _reduce_parts(parts: list, tensor_op, host_op, device):
  first = parts[0]
  if isinstance(first, torch.Tensor):
    return tensor_op(torch.stack([p.to(device) for p in parts]))
  if _is_namedtuple(first):
    return type(first)(*(_reduce_parts([p[i] for p in parts], tensor_op,
                                       host_op, device)
                         for i in range(len(first))))
  if isinstance(first, (tuple, list)):
    return type(first)(_reduce_parts([p[i] for p in parts], tensor_op,
                                     host_op, device)
                       for i in range(len(first)))
  return host_op(parts)


def _tree_bytes(tree) -> int:
  total = [0]

  def add(x):
    if isinstance(x, torch.Tensor):
      total[0] += x.numel() * x.element_size()
    return x
  tree_map(add, tree)
  return total[0]


def _collective(value, axes, tensor_op, host_op):
  frame = _frame()
  mesh = frame.call.mesh
  if isinstance(axes, str):
    axes = (axes,)
  dims = tuple(sorted(mesh.dim(a) for a in axes))
  if all(mesh.devices.shape[d] == 1 for d in dims):
    return value
  # The group's first device: the position with coordinate 0 along dims.
  root = tuple(0 if d in dims else c for d, c in enumerate(frame.position))
  root_device = mesh.devices[root]

  def reduce(parts):
    with _stats_lock:
      _stats["collectives"] += 1
      _stats["bytes"] += sum(_tree_bytes(p) for p in parts)
    return _reduce_parts(parts, tensor_op, host_op, root_device)

  result = frame.call.collective(frame.index, dims, frame.position, value,
                                 reduce)
  dev = frame.device
  return tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor)
                  and x.device != dev else x, result)


def psum(value, axes):
  """Sum over the mesh positions along ``axes`` (a name or a tuple of
  names): tensors, or trees of them, or host numbers. Tensors keep their
  dtype."""
  return _collective(value, axes,
                     lambda s: torch.sum(s, dim=0, dtype=s.dtype), sum)


def pmax(value, axes):
  """Maximum over the mesh positions along ``axes``."""
  return _collective(value, axes, lambda s: torch.amax(s, dim=0), max)


# --- shard_map ---


def _run(fn: Callable, call: _Call, positions, local_args) -> list:
  mesh = call.mesh
  streams = [torch.cuda.current_stream(d) for d in mesh.distinct_devices()
             if d.type == "cuda"]
  grad = torch.is_grad_enabled()
  results: List[Any] = [None] * len(positions)

  def work(i: int):
    prev = getattr(_local, "frame", None)
    pos = positions[i]
    device = mesh.devices[pos]
    try:
      with contextlib.ExitStack() as stack:
        for s in streams:
          stack.enter_context(torch.cuda.stream(s))
        if device.type == "cuda":
          stack.enter_context(torch.cuda.device(device))
        stack.enter_context(torch.set_grad_enabled(grad))
        _local.frame = _Frame(call, i, pos, device)
        call.start(i)
        results[i] = fn(*local_args[i])
    except BaseException as e:  # the first is raised on the calling thread
      with call.cond:
        call.fail(e)
    finally:
      _local.frame = prev
      call.finish(i)

  threads = [threading.Thread(target=work, args=(i,), daemon=True,
                              name=f"shard {positions[i]}")
             for i in range(len(positions))]
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  if call.error is not None:
    raise call.error
  return results


def _join(spec, outs: list, mesh: Mesh, positions):
  first = outs[0]
  if isinstance(spec, P):
    if _is_namedtuple(first):
      return type(first)(*(_join(spec, [o[i] for o in outs], mesh, positions)
                           for i in range(len(first))))
    if isinstance(first, (tuple, list)):
      return type(first)(_join(spec, [o[i] for o in outs], mesh, positions)
                         for i in range(len(first)))
    if spec.axis is None:
      return first
    pieces = np.empty(mesh.devices.shape, dtype=object)
    for pos, o in zip(positions, outs):
      pieces[pos] = o
    return Sharded(mesh, spec.axis, pieces)
  if _is_namedtuple(first):
    return type(first)(*(_join(s, [o[i] for o in outs], mesh, positions)
                         for i, s in enumerate(spec)))
  if isinstance(first, (tuple, list)):
    return type(first)(_join(s, [o[i] for o in outs], mesh, positions)
                       for i, s in enumerate(spec))
  raise TypeError(f"out spec {spec!r} for an output of type {type(first)}")


def shard_map(fn: Callable, mesh: Mesh, in_specs, out_specs) -> Callable:
  """``fn`` mapped over the mesh (``jax.shard_map``). ``in_specs`` holds one
  spec (tree) per positional argument: a ``Sharded`` argument with that
  layout gives each position its piece, a tensor is split (``P(axis)``) or
  replicated (``P()``), anything else is passed as it is. ``out_specs``
  says how each output joins: ``P()`` takes the first position's value,
  ``P(axis)`` makes a ``Sharded`` of every position's."""
  in_specs = tuple(in_specs)

  def mapped(*args):
    if len(args) != len(in_specs):
      raise TypeError(f"{len(args)} arguments for {len(in_specs)} specs")
    positions = mesh.positions()
    splits: Dict[tuple, List[torch.Tensor]] = {}

    def localize(pos):
      device = mesh.devices[pos]

      def leaf(x, spec: P):
        if isinstance(x, Sharded):
          if spec.axis is not None and spec.axis == x.axis and (
              x.mesh is mesh or x.pieces.shape == mesh.devices.shape):
            return replicate(x.pieces[pos], device)
          x = x.gather()
        if not isinstance(x, torch.Tensor):
          return x
        if spec.axis is None:
          return replicate(x, device)
        key = (id(x), spec.axis)
        if key not in splits:
          splits[key] = _split(x, mesh, spec.axis)
        return replicate(splits[key][pos[mesh.dim(spec.axis)]], device)

      return tuple(_map_spec(leaf, a, s) for a, s in zip(args, in_specs))

    local_args = [localize(pos) for pos in positions]
    outs = _run(fn, _Call(mesh), positions, local_args)
    return _join(out_specs, outs, mesh, positions)

  return mapped
