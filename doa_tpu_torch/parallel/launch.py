"""Start R ranks on one host and collect what each returns.

    spawn_ranks(target, world, args, device) → [rank 0's result, ...]

Each rank is a process started with the "spawn" method. The ranks meet
over a FileStore in a temporary directory (no TCP port to race for when
several launches run at once), take the backend that suits `device`
(gloo on the CPU and for ranks that share a card, nccl for one card a
rank: mesh.default_backend), set torch to one thread, and call
``target(device, *args)``. Its result must pickle (numpy arrays, numbers,
dicts of them). A rank that raises makes spawn_ranks raise with that
rank's traceback; the other ranks are then stopped. Nothing is swallowed.

A spawned rank imports the module that defines `target`, so targets live
in modules that import neither jax nor a test's conftest: ``run_jobs``
below, or a script's own function (chip_smoke.py).
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from doa_tpu_torch.parallel import sharded
from doa_tpu_torch.parallel.mesh import MeshSpec, default_backend, make_mesh


def _rank_main(target, rank, world, store_path, device, args, results):
    try:
        torch.set_num_threads(1)
        os.environ["LOCAL_RANK"] = str(rank)
        dist.init_process_group(
            default_backend(device, world),
            store=dist.FileStore(store_path, world), rank=rank,
            world_size=world)
        try:
            out = target(device, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def spawn_ranks(target, world: int, args=(), device="cuda",
                timeout: float = 600.0) -> list:
    """Run target(device, *args) on `world` ranks → their results, by
    rank. The ranks share this host's cards (cuda:{rank mod the card
    count}) unless `device` is "cpu". Raises RuntimeError when a rank raises, dies or the launch
    outlasts `timeout` seconds."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="doa_torch_ranks_") as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(target, r, world,
                                   os.path.join(tmp, "store"), device,
                                   tuple(args), results), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        outs, failure = {}, None
        deadline = time.monotonic() + timeout
        try:
            while len(outs) < world and failure is None:
                try:
                    rank, ok, val = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if not p.is_alive() and r not in outs]
                    if dead:
                        # a rank that exits puts its result first; allow
                        # the queue a moment to deliver it
                        try:
                            rank, ok, val = results.get(timeout=5.0)
                        except queue.Empty:
                            failure = (f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no "
                                       "result")
                            break
                    elif time.monotonic() > deadline:
                        failure = f"ranks did not finish in {timeout} s"
                        break
                    else:
                        continue
                if ok:
                    outs[rank] = val
                else:
                    failure = f"rank {rank} raised:\n{val}"
        finally:
            for p in procs:
                if failure is not None and p.is_alive():
                    p.terminate()
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
        if failure is not None:
            raise RuntimeError(f"spawn_ranks({world} ranks on {device}): "
                               f"{failure}")
    return [outs[r] for r in range(world)]


def _numpy(v):
    """Tensors (nested in dicts, lists, tuples) → numpy; the rest as is."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, dict):
        return {k: _numpy(u) for k, u in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_numpy(u) for u in v)
    return v


def _block(x: np.ndarray, mesh) -> np.ndarray:
    lo, hi = sharded._block_rows(x.shape[0], mesh)
    return x[lo:hi]


def _job(mesh, kind, kw):
    from doa_tpu_torch.ops.cuda.ring import halo_exchange
    dev = mesh.device
    if kind == "pipeline":
        pipe = sharded.build_sharded_pipeline(
            kw["cfg"], mesh, **kw.get("build", {}))
        return pipe(kw["x"], kw.get("correction"))
    if kind == "build_error":
        try:
            sharded.build_sharded_pipeline(kw["cfg"], mesh)
        except ValueError as e:
            return str(e)
        return None
    if kind == "pipeline_local":
        pipe = sharded.build_sharded_pipeline(
            kw["cfg"], mesh, **kw.get("build", {}))
        return pipe.local(_block(kw["x"], mesh), kw.get("correction"))
    if kind == "halo":
        plane = torch.from_numpy(_block(kw["x"], mesh)).to(dev)
        first = halo_exchange(plane, kw["overlap"], mesh, impl=kw["impl"])
        return first, halo_exchange(-plane, kw["overlap"], mesh,
                                    impl=kw["impl"])
    if kind == "merge_1d":
        P = torch.from_numpy(kw["P"]).to(dev)
        G_loc = P.shape[1] // mesh.axis_size("grid")
        g = mesh.axis_index("grid")
        return sharded._local_peaks_merge_1d(
            _block(P, mesh)[:, g * G_loc:(g + 1) * G_loc], kw["k"],
            kw["x_rng"], kw["refine"], mesh)
    if kind == "merge_2d":
        P = torch.from_numpy(kw["P"]).to(dev)
        G_loc = P.shape[1] // mesh.axis_size("grid")
        g = mesh.axis_index("grid")
        return sharded._local_peaks_merge_2d(
            _block(P, mesh)[:, g * G_loc:(g + 1) * G_loc], kw["k"],
            kw["g2"], kw["refine"], mesh)
    if kind == "covariance":
        return sharded.distributed_covariance(mesh)(kw["x"])
    raise ValueError(f"unknown job {kind!r}")


def run_jobs(device, spec: MeshSpec, jobs: dict):
    """A spawn_ranks target: make this rank's mesh of `spec` and run each
    job of `jobs` (name → (kind, kwargs)) on it → {name: this rank's
    result as numpy}, plus
    "coords" (this rank's snap and grid indices). Kinds: "pipeline"
    (build_sharded_pipeline(cfg, mesh, **build)(x, correction) on the
    global capture), "pipeline_local" (the same through .local on this
    rank's block), "build_error" (the message of the ValueError that
    build_sharded_pipeline(cfg, mesh) raises, or None), "halo"
    (halo_exchange of this rank's rows of x, then
    of their negation: both results, read after the second exchange;
    impl "pallas" is kernel 13), "merge_1d" / "merge_2d" (the O(k) peak
    merges of this rank's block of a global spectrum P), "covariance"
    (distributed_covariance). Configs must be the port's own."""
    mesh = make_mesh(spec, device=device)
    out = {"coords": dict(mesh.coords)}
    try:
        for name, (kind, kw) in jobs.items():
            out[name] = _numpy(_job(mesh, kind, kw))
    finally:
        mesh.close()
    return out
