"""Multi-process wiring for the port's CLIs — counterpart of
``fastdepth_tpu/parallel/distributed.py``.

The port runs one rank per device: a ``torch.distributed`` process group
whose rank ``k`` owns ``cuda:k % torch.cuda.device_count()`` (backend
NCCL), or the CPU under ``--device cpu`` (backend gloo).  There is no
fallback: gloo never carries CUDA tensors, and a missing card is never
replaced by the CPU.  Every rank runs the same program; each feeds its
contiguous rows of every global batch (``BatchLoader(**shard_kwargs())``),
holds identical parameters and optimizer state, and sees global results;
only rank 0 writes files.  The JAX package's flags start the ranks:

    python -m fastdepth_tpu_torch.cli.train --mesh-devices N ...

spawns N ranks on this host (``torch.multiprocessing``, spawn start
method; they meet through a ``FileStore`` in a temporary directory), and
``--mesh-devices 1`` runs in this process over a group of one, so the
one-card path issues every collective;

    python -m fastdepth_tpu_torch.cli.train --coord HOST:PORT \\
        --num-processes N --process-id K --mesh-devices N ...

makes each process one rank (``init_method="tcp://HOST:PORT"``), with
``FDTPU_COORD`` / ``FDTPU_NUM_PROCESSES`` / ``FDTPU_PROCESS_ID`` as the
defaults, so a launcher can template one command for every rank.  With
``--mesh-spatial S`` the job is ``N x S`` ranks (``--mesh-devices N``, 1
if absent): the image height shards S-way over each data row's ranks
(``parallel/mesh.py``).
"""

from __future__ import annotations

import datetime
import os
import pickle
import signal
import tempfile
import threading

import torch
import torch.distributed as dist

RESULT_FILE = "rank0_result.pkl"


def add_distributed_args(parser) -> None:
    """Install the multi-process flags on an argparse parser (shared by
    cli.train / cli.evaluate).  Defaults come from the FDTPU_* env vars
    so a launcher can export once and run the same command per rank."""
    g = parser.add_argument_group(
        "distributed", "multi-process data parallelism (every process runs this same "
        "command, one rank per device; batches shard per rank, state replicates)")
    g.add_argument(
        "--coord", default=os.environ.get("FDTPU_COORD"),
        metavar="HOST:PORT",
        help="torch.distributed rendezvous address (tcp://HOST:PORT); presence "
             "(flag or FDTPU_COORD) makes this process one rank of a job")
    g.add_argument(
        "--num-processes", type=int, metavar="N",
        default=int(os.environ["FDTPU_NUM_PROCESSES"])
        if os.environ.get("FDTPU_NUM_PROCESSES") else None,
        help="total process count (FDTPU_NUM_PROCESSES); equals --mesh-devices")
    g.add_argument(
        "--process-id", type=int, metavar="K",
        default=int(os.environ["FDTPU_PROCESS_ID"])
        if os.environ.get("FDTPU_PROCESS_ID") else None,
        help="this process's rank in [0, N) (FDTPU_PROCESS_ID)")


def init_distributed(args) -> bool:
    """Join the ``--coord`` job the parsed args name; returns True when
    this process became one rank of it (False: no distributed flag).
    Validation is up-front SystemExit, with the JAX package's messages —
    a bad rank otherwise dies minutes later inside a collective."""
    coord = getattr(args, "coord", None)
    n = getattr(args, "num_processes", None)
    pid = getattr(args, "process_id", None)
    if coord is None and n is None and pid is None:
        return False
    if coord is None:
        raise SystemExit(
            "--num-processes/--process-id need --coord HOST:PORT "
            "(or FDTPU_COORD)")
    if (n is None) != (pid is None):
        raise SystemExit(
            "--num-processes and --process-id come as a pair "
            "(both, or neither for TPU-pod auto-detection)")
    if n is None:
        raise SystemExit(
            "--coord needs --num-processes and --process-id: the port has no "
            "pod auto-detection (torch.distributed is told its world size and rank)")
    if not 0 <= pid < n:
        raise SystemExit(
            f"--process-id {pid} out of range for "
            f"--num-processes {n}")
    if n < 2:
        raise SystemExit(
            f"--num-processes {n}: multi-process mode needs >= 2 "
            "(drop the distributed flags to run single-process)")
    mesh_devices = getattr(args, "mesh_devices", None)
    n_space = getattr(args, "mesh_spatial", None)
    if n_space and mesh_world(args) != n:
        raise SystemExit(
            f"--mesh-devices {mesh_devices or 1} x --mesh-spatial {n_space} must equal "
            f"--num-processes {n}: the port runs one rank per device")
    if not n_space and mesh_devices is not None and mesh_devices != n:
        raise SystemExit(
            f"--mesh-devices {mesh_devices} must equal --num-processes {n}: "
            "the port runs one rank per device")
    init_group(getattr(args, "device", "cuda"), pid, n, init_method=f"tcp://{coord}")
    return True


def mesh_world(args):
    """The ranks the mesh flags ask for: ``--mesh-devices N`` (1 if absent)
    times ``--mesh-spatial S``, or None without either flag."""
    n = getattr(args, "mesh_devices", None)
    s = getattr(args, "mesh_spatial", None)
    return (n or 1) * (s or 1) if n or s else None


def init_group(device: str, rank: int, world: int, timeout: float = None, **kw) -> None:
    """Pin this rank's device (before the group exists: NCCL binds the
    current device), then join the group (``kw``: ``init_method`` or
    ``store``): NCCL for ``cuda``, gloo for ``cpu``.

    NCCL's flight recorder is off unless the environment turns it on
    (``TORCH_FR_BUFFER_SIZE``): it captures a stack trace for every
    collective, which costs more the deeper the Python stack, and a mesh
    train step issues two collectives a BatchNorm, half from inside
    autograd (PERF.md §6).  ``timeout``: seconds a collective may wait
    before it fails (the backend's default without)."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device is available "
                             "(pass --device cpu to run the ranks on the CPU over gloo)")
        if not any(v in os.environ for v in ("TORCH_FR_BUFFER_SIZE",
                                              "TORCH_NCCL_TRACE_BUFFER_SIZE")):
            os.environ["TORCH_FR_BUFFER_SIZE"] = "0"
        torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, rank=rank, world_size=world, **kw)
    if rank == 0:
        print(f"=> process group: {world} rank(s), backend {backend}", flush=True)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the rank that owns the side effects (prints, CSV,
    checkpoints, comparison PNGs).  All ranks run the same collectives;
    only the primary writes."""
    return process_index() == 0


def shard_kwargs(microbatches: int = 1, mesh=None) -> dict:
    """BatchLoader kwargs for this rank's rows of every global batch
    (identity in a single process).  ``microbatches`` (the train step's
    ``accum_steps``) gives each rank its share of every microbatch
    (``data.loader.shard_rows``).  ``mesh``: the rows of this rank's
    place on its ``data`` axis (the ranks of a space group load the same
    rows), else one share a process."""
    if mesh is not None:
        return {"num_shards": mesh.size, "shard_id": mesh.rank, "microbatches": microbatches}
    return {"num_shards": process_count(), "shard_id": process_index(),
            "microbatches": microbatches}


def validate_distributed_batches(distributed: bool, mesh_devices, n_space=None,
                                 **batch_sizes) -> None:
    """Shared CLI-arg validation for multi-process runs, raising
    SystemExit BEFORE any checkpoint/data/device work.  Multi-process
    mode requires an explicit global mesh, and every batch size must
    divide by the process count (each process feeds an equal shard of
    each global batch).

    ``batch_sizes``: flag-name -> value pairs, e.g.
    ``validate_distributed_batches(dist, args.mesh_devices,
    **{"--batch-size": args.batch_size})``.  ``n_space``: the
    ``--mesh-spatial`` ranks that share each process's rows (the batch
    divides by the process count over it)."""
    if distributed and not (mesh_devices or n_space):
        raise SystemExit(
            "multi-process mode needs --mesh-devices (the GLOBAL device "
            "count across all processes): the mesh is what ties the "
            "per-process batch shards into one SPMD step")
    n_proc = process_count() // (n_space or 1)
    for flag, value in batch_sizes.items():
        if value % n_proc:
            raise SystemExit(
                f"{flag} {value} must divide by the process count "
                f"{n_proc}: every process feeds an equal shard of each "
                "global batch")


def devices_available(device: str) -> int:
    """How many ranks of ``device`` this host holds: one a card for
    ``cuda``, one a core for ``cpu`` (gloo ranks)."""
    if device == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def launch(fn, args, *, timeout: float = None, stop=None):
    """Run ``fn(args)`` on every rank the flags ask for; returns rank 0's
    result.  ``--coord ...``: this process is one rank.  ``--mesh-devices
    N`` and/or ``--mesh-spatial S`` alone: N x S ranks on this host
    (:func:`mesh_world`), one in this process over a group of one, more
    spawned (``fn`` and ``args`` must pickle: a module-level function and
    an argparse namespace).  Neither: ``fn(args)`` with no group.  A mesh
    larger than the host's devices exits up front.  ``timeout``: the
    group's collective timeout in seconds (:func:`init_group`).
    ``stop``: an event that, once set, sends rank 0 of spawned ranks a
    SIGINT (a daemon's shutdown; a SIGINT to this process does the
    same), and then waits for the ranks to end."""
    if init_distributed(args):
        try:
            return fn(args)
        finally:
            dist.destroy_process_group()
    n = mesh_world(args)
    if not n:
        return fn(args)
    device = getattr(args, "device", "cuda")
    have = devices_available(device)
    if n > have:
        raise SystemExit(f"need {n} devices for the mesh, have {have}")
    with tempfile.TemporaryDirectory(prefix="fdtorch_ranks_") as tmp:
        if n == 1:
            init_group(device, 0, 1, timeout,
                       store=dist.FileStore(os.path.join(tmp, "store"), 1))
            try:
                return fn(args)
            finally:
                dist.destroy_process_group()
        # each spawned rank is a fresh interpreter: it takes its share of
        # this process's torch threads, not one thread per core
        threads = max(1, torch.get_num_threads() // n)
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, args, n, tmp, threads, timeout), nprocs=n,
            start_method="spawn", join=False)
        _join(ctx, stop)
        with open(os.path.join(tmp, RESULT_FILE), "rb") as f:
            return pickle.load(f)


def _join(ctx, stop) -> None:
    """Wait for spawned ranks (an error in one raises here, as torch's
    spawn raises it).  While they run, ``stop`` being set, or a SIGINT to
    this process where it can take one, is passed on to rank 0 as a
    SIGINT, once."""
    rank0 = ctx.processes[0].pid
    sent = []

    def forward(*_):
        if not sent:
            sent.append(True)
            os.kill(rank0, signal.SIGINT)

    previous = None
    if threading.current_thread() is threading.main_thread():
        previous = signal.signal(signal.SIGINT, forward)
    try:
        while not ctx.join(timeout=0.5):
            if stop is not None and stop.is_set():
                forward()
    finally:
        if previous is not None:
            signal.signal(signal.SIGINT, previous)


def _rank_main(rank: int, fn, args, world: int, tmp: str, threads: int,
               timeout: float = None) -> None:
    """One spawned rank of :func:`launch`: join the FileStore group, run
    ``fn(args)``, and from rank 0 hand the result back to the parent.
    A SystemExit becomes an error that the parent re-raises with its
    message (torch's spawn passes on only exceptions)."""
    torch.set_num_threads(threads)
    init_group(getattr(args, "device", "cuda"), rank, world, timeout,
               store=dist.FileStore(os.path.join(tmp, "store"), world))
    try:
        result = fn(args)
    except SystemExit as e:
        raise RuntimeError(f"rank {rank} exited: {e}") from None
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(tmp, RESULT_FILE), "wb") as f:
            pickle.dump(result, f)
