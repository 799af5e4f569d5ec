"""Process groups for data-parallel training (PyTorch port of
`ramdsir_tpu/parallel/distributed.py`).

The JAX package runs one SPMD program over a device mesh, and several hosts
join it through `jax.distributed.initialize`.  The port runs one process a
rank, joined by a `torch.distributed` process group:

- `launch(fn, world_size)` starts the ranks on this host (the `spawn` start
  method; they meet on 127.0.0.1 at a free port) and returns what each rank's
  `fn` returned.  A rank that raises fails the launch with its traceback, and
  the other ranks are stopped: nothing waits on a dead rank.
- `initialize()` with no arguments joins the group of a `torchrun` launch
  (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT set).

Backends: NCCL wants one GPU a rank (it refuses two ranks on one card);
gloo runs ranks on the CPU, and on CUDA tensors it offers all_reduce,
broadcast and barrier, which is all the train step uses, so several gloo
ranks may share one card.  The defaults are NCCL on cuda:{rank} where CUDA
is available and gloo on the CPU elsewhere.  Every group is made with a
finite timeout: a collective that a peer never joins raises after it.

`world()`, `rank()` and `in_group()` read the group; without one they are
1, 0 and False, and the port runs its single-process path.
"""
from __future__ import annotations

import datetime
import os
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 1800.0  # a collective's longest wait (rank 0 evaluates while the others wait)
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK")

Device = Union[str, torch.device]


def in_group() -> bool:
    """Whether this process is a rank of a process group."""
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if in_group() else 1


def rank() -> int:
    return dist.get_rank() if in_group() else 0


def under_torchrun() -> bool:
    """Whether the environment names this process's rank (a torchrun launch)."""
    return all(v in os.environ for v in TORCHRUN_VARS)


def default_backend(device: Device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_devices(devices: Sequence[Device], backend: str) -> None:
    """Raise for ranks the backend cannot place: NCCL needs a distinct
    visible GPU for every rank."""
    devs = [torch.device(d) for d in devices]
    if backend != "nccl":
        return
    if any(d.type != "cuda" for d in devs):
        raise ValueError(f"NCCL runs on CUDA devices, not {[str(d) for d in devs]}")
    visible = torch.cuda.device_count()
    index = [d.index or 0 for d in devs]
    if len(set(index)) != len(index):
        raise ValueError(f"NCCL wants one GPU a rank; ranks share {[str(d) for d in devs]} (use gloo)")
    if max(index) >= visible:
        raise ValueError(f"{len(devs)} NCCL ranks on {[str(d) for d in devs]} but {visible} visible GPU(s)")


def initialize(
    backend: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    init_method: Optional[str] = None,
    device: Optional[Device] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> torch.device:
    """Join a process group and return this rank's device (made current on
    a card).  With `rank`, `world_size` and `init_method` None, the
    environment of a torchrun launch names the group (init_method env://)
    and the device is cuda:LOCAL_RANK where CUDA is available, the CPU
    elsewhere."""
    if rank is None:
        if not under_torchrun():
            raise RuntimeError(f"initialize() without a rank needs a torchrun launch ({', '.join(TORCHRUN_VARS)})")
        rank, world_size, init_method = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://"
        if device is None:
            local = int(os.environ["LOCAL_RANK"])
            device = f"cuda:{local}" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device if device is not None else "cpu")
    backend = backend or default_backend(dev)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or (dev.index or 0) >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank}: device {dev} is not available")
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return dev


def local_batch_slice(global_batch: int) -> slice:
    """The rows of the global batch this rank builds (the host loaders'
    `rows`), as the JAX package's `local_batch_slice`: the global batch must
    divide by the world size (the host path pads nothing)."""
    n, i = world(), rank()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} ranks")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def to_host(obj: Any) -> Any:
    """obj with every tensor in it as a numpy array (what a rank returns
    crosses a pipe; a CUDA tensor cannot)."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def _rank_main(fn, rank_, world_size, device, backend, init_method, timeout_s, args, results) -> None:
    """One rank: join the group, run fn(rank, device, *args), report."""
    try:
        dev = initialize(backend, rank_, world_size, init_method, device, timeout_s)
        out = to_host(fn(rank_, dev, *args))
    except BaseException:  # reported to the launcher, which raises it
        results.put((rank_, False, traceback.format_exc()))
        os._exit(1)  # leave at once: a peer may be blocked in a collective with this rank
    results.put((rank_, True, out))
    dist.destroy_process_group()


def launch(
    fn: Callable,
    world_size: int,
    devices: Optional[Sequence[Device]] = None,
    backend: Optional[str] = None,
    args: Sequence = (),
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> List[Any]:
    """Run fn(rank, device, *args) in `world_size` new processes joined in one
    process group; returns the ranks' results in rank order (tensors as numpy
    arrays).  fn must be importable by name (a module-level function), and
    args picklable.  devices: each rank's device (default cuda:{rank} where
    CUDA is available, else the CPU); backend: default NCCL on CUDA devices,
    gloo on the CPU.  Raises, with the rank's traceback, as soon as a rank
    fails, and stops the others."""
    if world_size < 1:
        raise ValueError(f"world size {world_size}")
    if devices is None:
        devices = [f"cuda:{r}" for r in range(world_size)] if torch.cuda.is_available() else ["cpu"] * world_size
    devices = [str(d) for d in devices]
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    backend = backend or default_backend(devices[0])
    check_devices(devices, backend)
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("this PyTorch has no NCCL")
    if backend == "gloo" and not dist.is_gloo_available():
        raise RuntimeError("this PyTorch has no gloo")
    init_method = f"tcp://127.0.0.1:{free_port()}"
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.SimpleQueue()
    procs = [
        ctx.Process(
            target=_rank_main, name=f"rank{r}",
            args=(fn, r, world_size, devices[r], backend, init_method, timeout_s, tuple(args), results),
        )
        for r in range(world_size)
    ]
    out: dict = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            while not results.empty():
                r, ok, payload = results.get()
                if not ok:
                    raise RuntimeError(f"rank {r} of {world_size} failed:\n{payload}")
                out[r] = payload
            dead = [r for r, p in enumerate(procs) if r not in out and not p.is_alive()]
            if dead and results.empty():
                r = dead[0]
                raise RuntimeError(f"rank {r} of {world_size} exited with code {procs[r].exitcode} and no result")
            time.sleep(0.02)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[r] for r in range(world_size)]
