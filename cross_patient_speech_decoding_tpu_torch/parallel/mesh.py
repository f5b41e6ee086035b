"""Process-group parallelism: the mesh, the rank launcher, the sharding
helpers and the data-parallel train steps.

Port of ``cross_patient_speech_decoding_tpu/parallel/mesh.py``. The JAX
package runs one controller over a device mesh and lets ``shard_map`` and
XLA place the collectives. The port follows PyTorch's own model, which is
DDP's and the one NCCL needs: one process per device under
``torch.distributed``, each a rank of one process group. The mesh has one
axis, ``data``; its ``shape["data"]`` is the world size.

- A rank owns one device: ``cuda:r`` for ranks the launcher starts itself,
  or the device the caller names. Collectives are NCCL where every rank
  has a card of its own, gloo on the CPU and where ranks share a card
  (NCCL refuses two ranks on one GPU). The backend is chosen before the
  group is made and never changed after a failure.
- :func:`launch` starts N ranks as child processes (``spawn``), which meet
  through a ``FileStore`` in a temporary directory (no network, no port to
  clash), and returns rank 0's result. An exception in any rank fails the
  launch and stops the others; the launch has a deadline; the process
  group's collectives time out after ``PG_TIMEOUT_S``.
- Every rank holds the whole batch, as the drivers prepare the same data on
  every rank; a sharded step keeps this rank's contiguous dim-0 block
  (:func:`shard_batch`) and reduces gradients with one ``all_reduce`` of a
  flat buffer.

Rank r > 0 of a data-parallel step draws dropout from a generator of its
own, seeded from the step generator's seed and r (the counterpart of
``fold_in(key, axis_index)``); rank 0 draws from the step's generator, so
that one rank repeats the one-device step.
"""

from __future__ import annotations

import ctypes
import datetime
import multiprocessing as mp
import multiprocessing.connection
import os
import pickle
import signal
import tempfile
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

import torch
import torch.distributed as dist
import torch.nn.functional as F

from cross_patient_speech_decoding_tpu_torch.utils.device import (
    resolve_device,
)

DATA_AXIS = "data"
# a collective that waits longer than this fails (and so does its rank)
PG_TIMEOUT_S = 120.0
# the deadline of a launch a driver makes for ``n_devices > 0``
LAUNCH_TIMEOUT_S = 24 * 3600.0
# the device of this process when the launcher started it
_LAUNCH_DEVICE: torch.device | None = None
# rank r > 0's dropout generator is seeded seed + _RANK_SEED_STRIDE * r
_RANK_SEED_STRIDE = 0x9E3779B97F4A7C15


@dataclass(frozen=True)
class Mesh:
    """This rank's view of a one-axis mesh of ``size`` ranks.

    ``group`` is the process group (None for a one-rank mesh made without
    one: then no collective runs). ``shape[axis]`` is the world size, as
    ``jax.sharding.Mesh.shape`` reads.
    """

    size: int
    rank: int
    device: torch.device
    group: object = None
    axis_names: tuple = (DATA_AXIS,)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.size}


def _cuda_index(dev: torch.device) -> torch.device:
    return torch.device("cuda", dev.index or 0) if dev.type == "cuda" else dev


def rank_devices(n: int, device=None) -> list:
    """The device of each of ``n`` ranks: ``cuda:0`` .. ``cuda:n-1`` for
    ``device=None`` (raising when there are fewer cards), every rank on
    ``device`` when it names one, or ``device[r]`` from a list."""
    if n < 1:
        raise ValueError(f"n_devices={n}: a mesh needs at least one rank")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        count = torch.cuda.device_count()
        if n > count:
            raise ValueError(f"n_devices={n} requested but only {count} "
                             "device(s) available (cuda backend)")
        return [torch.device("cuda", i) for i in range(n)]
    if isinstance(device, (list, tuple)):
        if len(device) != n:
            raise ValueError(f"{len(device)} devices given for {n} ranks")
        return [_cuda_index(resolve_device(d)) for d in device]
    return [_cuda_index(resolve_device(device))] * n


def default_backend(devices) -> str:
    """NCCL where every rank has a card of its own, else gloo."""
    cuda = all(d.type == "cuda" for d in devices)
    return "nccl" if cuda and len(set(devices)) == len(devices) else "gloo"


def _rank_device(device, rank: int) -> torch.device:
    if isinstance(device, (list, tuple)):
        return _cuda_index(resolve_device(device[rank]))
    if device is not None:
        return _cuda_index(resolve_device(device))
    if _LAUNCH_DEVICE is not None:
        return _LAUNCH_DEVICE
    # torchrun: one card a local rank
    local = int(os.environ.get("LOCAL_RANK", rank))
    return _cuda_index(resolve_device(f"cuda:{local}"))


def make_mesh(n_devices: int | None = None, data_axis: str = DATA_AXIS,
              device=None) -> Mesh:
    """This rank's mesh of ``n_devices`` ranks.

    Inside a process group (a :func:`launch`, or ``torchrun``) the mesh is
    the group, and ``n_devices`` must be its world size. Without one, only
    a one-rank mesh can be made here; asking for more cards than
    ``torch.cuda.device_count()`` raises JAX's ``ValueError`` either way.
    ``device`` names this rank's device (a list: one a rank); the default
    is the launcher's, else ``cuda:LOCAL_RANK``.
    """
    if dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        if n_devices is not None and n_devices != size:
            raise ValueError(f"n_devices={n_devices} requested but the "
                             f"process group has {size} rank(s)")
        return Mesh(size, rank, _rank_device(device, rank),
                    dist.group.WORLD, (data_axis,))
    n = 1 if n_devices is None else n_devices
    devices = rank_devices(n, device)
    if n != 1:
        raise RuntimeError(
            f"make_mesh(n_devices={n}) needs a process group of {n} ranks: "
            "call it inside parallel.launch or torchrun, or give a driver "
            "n_devices and let it launch the ranks")
    return Mesh(1, 0, devices[0], None, (data_axis,))


def needs_launch(n_devices: int) -> bool:
    """True where a driver asked for ``n_devices > 0`` must start its
    ranks: no process group is initialised in this process."""
    return n_devices > 0 and not dist.is_initialized()


def mesh_and_device(n_devices: int, device=None):
    """(mesh, this rank's device) of a driver: (None, the device) for
    ``n_devices == 0``."""
    if n_devices > 0:
        mesh = make_mesh(n_devices, device=device)
        return mesh, mesh.device
    return None, resolve_device(device)


def is_writer(mesh: Mesh | None) -> bool:
    """Whether this process writes the run's files: rank 0 only."""
    return mesh is None or mesh.rank == 0


def from_rank0(fn, mesh: Mesh | None):
    """``fn()`` run on rank 0 alone (a resume read that may set a stale
    file aside), its picklable result handed to every rank: no other rank
    touches the file, and none reads it while rank 0 moves it."""
    if mesh is None or mesh.group is None:
        return fn()
    out = [fn() if mesh.rank == 0 else None]
    dist.broadcast_object_list(out, src=0, group=mesh.group)
    return out[0]


def init_from_env(device=None) -> bool:
    """Join the process group that ``torchrun`` describes in the
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``PORT``), one
    rank a device (``cuda:LOCAL_RANK`` by default; NCCL on distinct cards,
    else gloo). True when a group was initialised here; False outside
    ``torchrun`` or when a group exists."""
    if dist.is_initialized() or "RANK" not in os.environ \
            or "WORLD_SIZE" not in os.environ:
        return False
    global _LAUNCH_DEVICE
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    _LAUNCH_DEVICE = _rank_device(device, rank)
    if _LAUNCH_DEVICE.type == "cuda":
        torch.cuda.set_device(_LAUNCH_DEVICE)
    devs = (rank_devices(size, device) if device is not None
            else [torch.device("cuda", r) for r in range(size)])
    dist.init_process_group(
        default_backend(devs), init_method="env://", rank=rank,
        world_size=size, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    return True


# ------------------------------------------------------------- launcher --

def _die_with_parent() -> None:
    """Ask Linux to kill this process when its parent dies (no-op
    elsewhere)."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PDEATHSIG
    except (OSError, AttributeError):
        pass


def _to_cpu(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _write_atomic(path: Path, obj) -> None:
    tmp = path.with_suffix(".tmp")
    tmp.write_bytes(pickle.dumps(obj))
    os.replace(tmp, path)


def _rank_main(rank, n, device, backend, tmp, fn, args, kwargs, threads,
               pg_timeout):
    """A rank's process: join the group, run ``fn``, leave rank 0's result
    (or this rank's exception) in ``tmp`` for the launcher."""
    global _LAUNCH_DEVICE
    _die_with_parent()
    tmp = Path(tmp)
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        _LAUNCH_DEVICE = dev
        store = dist.FileStore(str(tmp / "store"), n)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=pg_timeout))
        out = fn(*args, **kwargs)
        if rank == 0:
            _write_atomic(tmp / "result.pkl", _to_cpu(out))
    except BaseException as e:  # noqa: BLE001 - ends the process below
        try:
            pickle.loads(pickle.dumps(e))
        except Exception:  # noqa: BLE001 - an exception that cannot travel
            e = None
        _write_atomic(tmp / f"error_{rank}.pkl",
                      (e, traceback.format_exc(), time.time()))
        # no group teardown: a peer may be gone, and NCCL's would wait
        os._exit(1)
    dist.destroy_process_group()


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5.0)
        if p.is_alive():
            p.kill()
            p.join(5.0)


class RankError(RuntimeError):
    """A rank of a launch failed; the message holds its traceback."""


def _rank_failure(tmp: Path, procs) -> BaseException:
    errs = []
    for r in range(len(procs)):
        f = tmp / f"error_{r}.pkl"
        if f.exists():
            e, tb, t = pickle.loads(f.read_bytes())
            errs.append((t, r, e, tb))
    if not errs:
        codes = [p.exitcode for p in procs]
        return RankError(f"a rank died without a traceback: exit codes "
                         f"{codes}")
    _, r, e, tb = min(errs, key=lambda x: x[0])  # the first to fail
    cause = RankError(f"rank {r} of {len(procs)} failed:\n{tb}")
    if e is None:
        return cause
    e.__cause__ = cause
    return e


def launch(fn, n_ranks: int, args=(), kwargs=None, *, devices=None,
           backend: str | None = None, timeout: float | None = None):
    """Run ``fn(*args, **kwargs)`` on ``n_ranks`` ranks and return rank 0's
    result (tensors moved to the CPU).

    Each rank is a process started with ``spawn``, with a process group of
    ``n_ranks`` initialised (``PG_TIMEOUT_S``) and its device set:
    ``devices`` as :func:`rank_devices` reads it. ``backend`` defaults to
    :func:`default_backend`. ``fn`` must be importable by name (a module's
    function). An exception in a rank terminates the others and is raised
    here, with the rank's traceback as its cause; ``timeout`` seconds
    (None: no deadline) end the launch with ``TimeoutError``. CPU ranks
    share this process's torch threads among them. No process outlives the
    call.
    """
    devs = rank_devices(n_ranks, devices)
    backend = backend or default_backend(devs)
    if backend == "nccl" and len(set(devs)) < n_ranks:
        raise ValueError("NCCL takes one rank a card; ranks that share a "
                         "card need backend='gloo'")
    threads = (max(1, torch.get_num_threads() // n_ranks)
               if all(d.type == "cpu" for d in devs) else None)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="cpsd_ranks_") as tmp:
        tmp = Path(tmp)
        procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(r, n_ranks, str(devs[r]), backend, str(tmp),
                              fn, tuple(args), dict(kwargs or {}), threads,
                              PG_TIMEOUT_S))
            for r in range(n_ranks)]
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            for p in procs:
                p.start()
            while True:
                codes = [p.exitcode for p in procs]
                if any(c not in (None, 0) for c in codes):
                    _stop(procs)
                    raise _rank_failure(tmp, procs)
                if all(c == 0 for c in codes):
                    break
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{n_ranks} ranks still running after {timeout} s")
                multiprocessing.connection.wait(
                    [p.sentinel for p in procs if p.exitcode is None],
                    timeout=0.5)
        finally:
            _stop(procs)
        return pickle.loads((tmp / "result.pkl").read_bytes())


def launch_driver(fn, n_devices: int, device, *args, **kwargs):
    """A driver's own launch for ``n_devices > 0``: ``fn(*args,
    device=device, **kwargs)`` on ``n_devices`` ranks (``device`` as
    :func:`rank_devices` reads it), rank 0's result back, deadline
    ``LAUNCH_TIMEOUT_S``."""
    return launch(fn, n_devices, args, {**kwargs, "device": device},
                  devices=device, timeout=LAUNCH_TIMEOUT_S)


# ------------------------------------------------------------- sharding --

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def block_range(n: int, mesh: Mesh) -> tuple:
    """[start, stop) of this rank's contiguous block of ``n`` rows;
    ``n`` must divide by the mesh."""
    if n % mesh.size:
        raise ValueError(f"dim 0 of {n} rows does not divide the "
                         f"{mesh.size}-rank mesh")
    b = n // mesh.size
    return mesh.rank * b, (mesh.rank + 1) * b


class Sharding:
    """How an array lies on the mesh: its dim 0 split in contiguous blocks
    over ``axis`` (this rank keeps its own), or replicated (``axis``
    None: every rank keeps all of it). Calling it on an array gives this
    rank's part."""

    def __init__(self, mesh: Mesh, axis: str | None):
        self.mesh, self.axis = mesh, axis

    def __call__(self, x):
        if self.axis is None:
            return x
        lo, hi = block_range(x.shape[0], self.mesh)
        return x[lo:hi]


def batch_sharding(mesh: Mesh, ndim: int = 1, axis: str = DATA_AXIS):
    """Dim 0 split over the data axis, the rest replicated (``ndim`` is
    kept for JAX's signature: a block of dim 0 is the same for any
    rank)."""
    return Sharding(mesh, axis)


def replicated(mesh: Mesh):
    return Sharding(mesh, None)


def shard_batch(batch, mesh: Mesh, axis: str = DATA_AXIS):
    """This rank's contiguous dim-0 block of every array of a pytree
    (tuple, list, dict)."""
    sh = batch_sharding(mesh, 1, axis)
    return _tree_map(sh, batch)


def _pad_with_weights(batch, n_dev: int):
    """Pad a batch tuple's dim 0 to a multiple of ``n_dev`` by repeating
    leading rows and return the sample weights, 1 for real rows and 0 for
    the padding (JAX's padding, for tensors): a weighted reduction over the
    padded sharded batch then equals the unpadded one."""
    n = batch[0].shape[0]
    pad = (-n) % n_dev
    dev = batch[0].device
    w = torch.ones(n, dtype=torch.float32, device=dev)
    if pad:
        idx = torch.arange(pad, device=dev) % n
        batch = tuple(torch.cat([a, a[idx.to(a.device)]]) for a in batch)
        w = torch.cat([w, torch.zeros(pad, dtype=torch.float32, device=dev)])
    return batch, w


# ----------------------------------------------------------- collectives --

def _staged(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend can reduce it: gloo's on the host."""
    if t.is_cuda and dist.get_backend(mesh.group) == "gloo":
        return t.cpu()
    return t.contiguous()


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks, on ``t``'s device (``t`` itself on
    a mesh without a group)."""
    if mesh.group is None:
        return t
    buf = _staged(mesh, t)
    dist.all_reduce(buf, group=mesh.group)
    return buf.to(t.device)


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's equal-shaped ``t`` concatenated along dim 0 in rank
    order, on ``t``'s device."""
    if mesh.group is None:
        return t
    buf = _staged(mesh, t)
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(parts, buf, group=mesh.group)
    return torch.cat(parts).to(t.device)


def gather_objects(obj, mesh: Mesh) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    if mesh.group is None:
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def map_fold_blocks(fn, mesh: Mesh, *fold_trees):
    """``fn`` over a fold axis sharded on the mesh: every tensor of
    ``fold_trees`` has the folds on dim 0; they are padded to a multiple of
    the world size by repeating leading folds, this rank calls ``fn`` on
    its contiguous block, and each tensor ``fn`` returns (one, or a tuple)
    is gathered and cut back to the fold count."""
    n = _leaves(fold_trees)[0].shape[0]
    padded = (n + (-n) % mesh.size)

    def block(a):
        idx = torch.arange(padded, device=a.device) % n
        lo, hi = block_range(padded, mesh)
        return a[idx[lo:hi]]

    out = fn(*_tree_map(block, fold_trees))
    return _tree_map(lambda t: all_gather_rows(t, mesh)[:n], out)


# ------------------------------------------------------------ train steps --

class _RankGenerator:
    """Rank r's dropout generator for a step generator: the generator
    itself on rank 0, else one seeded ``initial_seed + stride * r`` (mod
    2**63), made again when the step is given another generator."""

    def __init__(self, rank: int):
        self.rank, self._src, self._gen = rank, None, None

    def __call__(self, generator):
        if self.rank == 0 or generator is None:
            return generator
        if generator is not self._src:
            seed = ((generator.initial_seed() + _RANK_SEED_STRIDE * self.rank)
                    % (1 << 63))
            self._src = generator
            self._gen = torch.Generator(device=generator.device).manual_seed(
                seed)
        return self._gen


def _param_device(model) -> torch.device:
    return next(model.parameters()).device


def _local_rows(batch, mesh: Mesh, n_data: int, dev):
    """This rank's block of a global batch of ``n_data`` arrays with an
    optional trailing sample-weight vector (default: ones), on ``dev``."""
    batch = tuple(batch)
    if len(batch) == n_data:
        n = batch[0].shape[0]
        batch = batch + (torch.ones(n, dtype=torch.float32,
                                    device=batch[0].device),)
    local = shard_batch(batch, mesh)
    return tuple(t.to(dev) for t in local)


def _reduce_grads(model, mesh: Mesh, w_sum, *sums):
    """All-reduce every gradient (local weighted sums), the local weight
    total and ``sums`` in one flat buffer; divide by ``max(w_tot, 1)``.
    Gradients are written back in place; returns the global means of
    ``sums``."""
    params = [p for p in model.parameters() if p.requires_grad]
    flat = torch.cat(
        [(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
         for p in params]
        + [w_sum.reshape(1).to(params[0].dtype)]
        + [s.detach().reshape(1).to(params[0].dtype) for s in sums])
    flat = all_reduce_sum(flat, mesh)
    k = len(sums)
    w_tot = flat[-k - 1].clamp(min=1.0)
    flat = flat / w_tot
    i = 0
    for p in params:
        g = flat[i:i + p.numel()].view_as(p)
        if p.grad is None:
            p.grad = g.clone()
        else:
            p.grad.copy_(g)
        i += p.numel()
    return tuple(flat[len(flat) - k + j] for j in range(k))


def make_sharded_ctc_train_step(model, tx, mesh: Mesh,
                                axis: str = DATA_AXIS):
    """Data-parallel CTC train step: ``step(state, batch, generator) ->
    (state, {"loss"})`` with the one-device step's interface
    (``train.steps.make_ctc_train_step``).

    Every rank is given the whole batch (x, labels, input_lens,
    label_lens[, w]) and trains on its contiguous block of rows (dim 0 must
    divide by the mesh: :func:`make_padded_sharded_ctc_train_step` pads).
    Each rank computes its block's weighted loss SUM and its gradients;
    one ``all_reduce`` sums the gradients, the weight total and the loss,
    which are divided by ``max(w_tot, 1)``: the exact global weighted mean,
    so zero-weight rows contribute nothing. AdamW and the schedule then
    step identically on every rank, which keeps the replicas equal.
    """
    from cross_patient_speech_decoding_tpu_torch.models.realtime_rnn import (
        adjusted_input_lengths,
    )
    from cross_patient_speech_decoding_tpu_torch.ops.ctc import ctc_loss_mean
    from cross_patient_speech_decoding_tpu_torch.train.steps import _update

    win, stride, blank = model.win_size, model.stride, model.blank
    rank_gen = _RankGenerator(mesh.rank)

    def step(state, batch, generator: torch.Generator | None = None):
        m = state.model
        x, labels, input_lens, label_lens, w = _local_rows(
            batch, mesh, 4, _param_device(m))
        in_adj = adjusted_input_lengths(input_lens, win, stride)
        m.train()
        state.optimizer.zero_grad(set_to_none=True)
        logits = m(x, generator=rank_gen(generator))
        w_sum = w.sum()
        loss_sum = ctc_loss_mean(logits, in_adj, labels, label_lens, blank,
                                 weights=w) * w_sum.clamp(min=1.0)
        loss_sum.backward()
        (loss,) = _reduce_grads(m, mesh, w_sum, loss_sum)
        _update(state, tx)
        return state, {"loss": loss}

    return step


def make_padded_sharded_ctc_train_step(model, tx, mesh: Mesh,
                                       axis: str = DATA_AXIS):
    """:func:`make_sharded_ctc_train_step` for any batch size: a batch
    whose dim 0 does not divide the mesh gets zero-weight repeated rows
    (:func:`_pad_with_weights`), so the step equals the unpadded
    one-device step up to the order of the sums."""
    raw = make_sharded_ctc_train_step(model, tx, mesh, axis)

    def step(state, batch, generator: torch.Generator | None = None):
        batch, w = _pad_with_weights(tuple(batch), mesh.size)
        return raw(state, (*batch, w), generator)

    return step


def _batch_norms(model) -> list:
    from cross_patient_speech_decoding_tpu_torch.models.layers import (
        BatchNorm,
    )

    return [m for m in model.modules() if isinstance(m, BatchNorm)]


def make_sharded_classifier_train_step(model, tx, mesh: Mesh,
                                       axis: str = DATA_AXIS):
    """Data-parallel classifier step (the TCN, transformer and GRU
    families): ``step(state, (x, y), generator) -> (state, {"loss",
    "acc"})``, any batch size (zero-weight repeated rows pad it to the
    mesh, as in JAX).

    The reductions are those of :func:`make_sharded_ctc_train_step`: loss,
    gradients and accuracy are exact global weighted means (``acc`` the
    weighted share of argmax hits). A model with BatchNorm normalises with
    each shard's own batch statistics (no SyncBatchNorm, as JAX's
    ``shard_map``), the padding rows of the last shard among them; the
    running statistics are averaged over the ranks after the forward.
    """
    from cross_patient_speech_decoding_tpu_torch.train.steps import _update

    rank_gen = _RankGenerator(mesh.rank)
    norms = _batch_norms(model)

    def step(state, batch, generator: torch.Generator | None = None):
        m = state.model
        batch, w = _pad_with_weights(tuple(batch), mesh.size)
        x, y, w = _local_rows((*batch, w), mesh, 2, _param_device(m))
        y = y.long()
        m.train()
        state.optimizer.zero_grad(set_to_none=True)
        logits = m(x, generator=rank_gen(generator))
        ce = F.cross_entropy(logits, y, reduction="none")
        loss_sum = (ce * w).sum()
        loss_sum.backward()
        correct = ((logits.detach().argmax(dim=-1) == y).float() * w).sum()
        loss, acc = _reduce_grads(m, mesh, w.sum(), loss_sum, correct)
        if norms and mesh.group is not None:
            stats = [t for bn in norms for t in (bn.mean, bn.var)]
            flat = all_reduce_sum(
                torch.cat([t.reshape(-1) for t in stats]), mesh) / mesh.size
            i = 0
            for t in stats:
                t.copy_(flat[i:i + t.numel()].view_as(t))
                i += t.numel()
        _update(state, tx)
        return state, {"loss": loss, "acc": acc}

    return step
