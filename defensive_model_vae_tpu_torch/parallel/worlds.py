"""Rank programs for :func:`.launch.spawn_world`.

Each function here runs on every rank of a spawned world: it builds its
mesh with :func:`.mesh.create_mesh` on the rank's ``device``, runs one of
the port's mesh paths, and returns numpy (results travel back pickled).
The CPU tests and ``chip_smoke.py`` share them; they live in the package so
that ``spawn`` can import them in a fresh interpreter without the caller's
module.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import time

import numpy as np
import torch

from .mesh import create_mesh


def to_numpy(obj):
    """Tensors (nested in dicts, lists and tuples) → numpy arrays."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy(v) for v in obj)
    return obj


def _resolve(target: str):
    module, name = target.split(":")
    return getattr(importlib.import_module(module), name)


def run_all(device, calls):
    """Each ``(program, args, kwargs)`` of ``calls`` in turn, in one world →
    their results in order."""
    return [fn(device, *args, **kwargs) for fn, args, kwargs in calls]


def call_with_mesh(device, target: str, *args, mesh_shape=None, **kwargs):
    """``target(*args, mesh=mesh, **kwargs)`` as numpy, ``target`` named
    ``"package.module:function"``."""
    mesh = create_mesh(shape=mesh_shape, device=device)
    return to_numpy(_resolve(target)(*args, mesh=mesh, **kwargs))


def mesh_facts(device, n_rows: int):
    """What :func:`create_mesh`, ``shard_batch``, ``replicate`` and
    ``gather_rows`` give on this rank: the mesh shapes (the world as a
    (world, 1) mesh and as (world/2, 2)), the refusals' messages, this
    rank's block of an ``n_rows`` × 3 batch, rank 0's tensor replicated,
    and the blocks gathered back."""
    import torch.distributed as dist

    from .mesh import gather_rows, padded_rows, replicate, shard_batch

    world = dist.get_world_size()
    mesh = create_mesh(device=device)
    out = {"shape": mesh.shape, "size": mesh.size, "coordinate": mesh.coordinate,
           "two_by": create_mesh(shape=(world // 2, 2), device=device).shape,
           "prefix": create_mesh(shape=(1, 2), device=device).coordinate}
    errors = []
    for kw in ({"shape": (world, 2)}, {"n_devices": world, "shape": (1, world - 1)}):
        try:
            create_mesh(device=device, **kw)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    batch = torch.arange(n_rows * 3, dtype=torch.float32, device=mesh.device).reshape(n_rows, 3)
    blk = shard_batch(batch, mesh)
    out.update(padded=padded_rows(n_rows, mesh), block=blk.cpu().numpy(),
               gathered=gather_rows(blk, mesh).cpu().numpy())
    mine = torch.full((2, 2), float(dist.get_rank()), device=mesh.device)
    out["replicated"] = replicate({"a": {"w": mine}}, mesh)["a"]["w"].cpu().numpy()
    return out


def train_step(device, params, eps, batch, mask=None, train_cfg=None):
    """One ``make_parallel_train_step`` step of ``train.make_train_step`` on
    this rank's blocks of the global ``eps``/``batch``/``mask`` (numpy),
    from ``params`` (numpy) → (params, metrics).  Rows padded onto a batch
    that does not split evenly get mask 0."""
    from ..models import CVAEConfig
    from ..train import TrainConfig, init_opt_state, make_train_step
    from ..train.checkpoint import params_from_numpy
    from .mesh import block, make_parallel_train_step, padded_rows, shard_batch

    mesh = create_mesh(device=device)
    cfg = CVAEConfig(seq_len=batch.shape[1], dim=batch.shape[2])
    p = params_from_numpy(params, mesh.device)
    step = make_parallel_train_step(make_train_step(cfg, train_cfg or TrainConfig()), mesh)

    def rows(a):
        return shard_batch(torch.as_tensor(np.asarray(a, np.float32)).to(mesh.device), mesh)

    n, n_pad = len(batch), padded_rows(len(batch), mesh)
    if mask is not None or n_pad != n:
        full = np.zeros(n_pad, np.float32)
        full[:n] = 1.0 if mask is None else mask
        mask = torch.as_tensor(full[block(n_pad, mesh)]).to(mesh.device)
    p, _, metrics = step(p, init_opt_state(p), rows(eps), rows(batch), mask)
    return to_numpy(p), {k: float(v) for k, v in metrics.items()}


def tensor_parallel_forward(device, params, x_rel, cond, eps, mesh_shape):
    """The CVAE forward (encode, z = mu + eps·σ, decode) with
    ``tensor_shard_params``' DTensor params over the model axis → (recon,
    the unsharded forward's recon on this rank, the placements used)."""
    from ..models import CVAEConfig
    from ..models.cvae import decode, encode
    from ..train.checkpoint import params_from_numpy
    from .mesh import model_replicated, tensor_shard_params

    mesh = create_mesh(shape=mesh_shape, device=device)
    cfg = CVAEConfig(seq_len=x_rel.shape[1], dim=x_rel.shape[2])
    p = params_from_numpy(params, mesh.device)
    x, c, e = (torch.as_tensor(np.asarray(a, np.float32)).to(mesh.device)
               for a in (x_rel, cond, eps))

    def forward(pp, xx, cc, ee):
        mu, lv, hc = encode(pp, xx, cc)
        return decode(pp, mu + ee * torch.exp(0.5 * lv), hc, cfg)

    ps = tensor_shard_params(p, mesh, hidden_dim=cfg.hidden_dim)
    out = forward(ps, *(model_replicated(a, mesh) for a in (x, c, e))).full_tensor()
    placements = {f"{k}.{n}": str(a.placements[0]) for k, v in ps.items()
                  for n, a in v.items()}
    return out.cpu().numpy(), forward(p, x, c, e).cpu().numpy(), placements


def serve_program(device, params, mpc_cfg, num_steps, seed, starts, inits, z=None,
                  model_cfg=None):
    """``make_serve_fn(mesh=...)`` on the batch → (states, controls)."""
    from ..control.device_reference import make_serve_fn
    from ..models import CVAEConfig
    from ..train.checkpoint import params_from_numpy

    mesh = create_mesh(device=device)
    fn = make_serve_fn(params_from_numpy(params, mesh.device), model_cfg or CVAEConfig(),
                       mpc_cfg, num_steps, mesh=mesh)
    return to_numpy(fn(seed, starts, inits, None if z is None else torch.as_tensor(z)))


def generate_program(device, ckpt_dir, seed, starts):
    """``serving.build_generate_fn(mesh=...)`` on ``starts``."""
    from ..serving import build_generate_fn

    mesh = create_mesh(device=device)
    return to_numpy(build_generate_fn(ckpt_dir, mesh=mesh)(seed, starts))


def http_program(device, ckpt, batch, num_steps, bodies, dt=0.1, warm_seed=1,
                 fail_call=None):
    """A data-parallel ``serve_checkpoint``: rank 0 serves ``bodies`` (JSON
    objects, each POSTed to its ``"path"``) from a thread and closes the
    server, which stops the other ranks → rank 0: the responses; the
    others: None.  ``fail_call`` (rank, k): on that rank the k-th call of
    the serve program's reference build (the warm-up's is the first) raises,
    as a request that fails on one rank alone."""
    import torch.distributed as dist

    from ..control import device_reference

    build, calls = device_reference.build_reference_device, []

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) == fail_call[1]:
            raise RuntimeError(f"a failure on rank {fail_call[0]}")
        return build(*args, **kwargs)

    mesh = create_mesh(device=device)
    if fail_call is not None and dist.get_rank() == fail_call[0]:
        device_reference.build_reference_device = failing
    try:
        return _http_requests(mesh, ckpt, batch, num_steps, bodies, dt, warm_seed)
    finally:
        device_reference.build_reference_device = build


def _http_requests(mesh, ckpt, batch, num_steps, bodies, dt, warm_seed):
    import json
    import threading
    import urllib.error
    import urllib.request

    from ..serving import serve_checkpoint

    server = serve_checkpoint(ckpt, batch, num_steps, dt=dt, warm_seed=warm_seed,
                              mesh=mesh)
    if server is None:
        return None
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    host, port = server.server_address[:2]
    out = []
    try:
        for body in bodies:
            body = dict(body)
            path = body.pop("path", "/serve")
            req = urllib.request.Request(f"http://{host}:{port}{path}",
                                         data=json.dumps(body).encode())
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    out.append((r.status, json.loads(r.read())))
            except urllib.error.HTTPError as e:
                out.append((e.code, json.loads(e.read())))
    finally:
        server.shutdown()
        server.server_close()
    return out


def cli_program(device, argv):
    """``cli.main(argv)`` on every rank → this rank's standard output."""
    from .. import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(list(argv))
    return buf.getvalue()


def dp_timed(device, windows, **kwargs):
    """``fused_train_scale_dp(mesh=...)`` on ``windows``, timed from its own
    epochs → {"params", "history", "wall_s", "k4_launches" (this rank's K4
    launches in the run), "k4_ms" (the median of its K4 calls) and
    "allreduce_ms" (the median of its all-reduces, one an epoch), both by
    the device times of the run's epoch spans (None off CUDA),
    "block_rows" (this rank's rows)}."""
    from ..ops import fused_scale as fs
    from ..utils.profiling import recording

    mesh = create_mesh(device=device)
    cuda = mesh.device.type == "cuda"
    before = fs._grad_epoch_call.launches
    with recording() as rec:
        t0 = time.perf_counter()
        params, hist = fs.fused_train_scale_dp(windows, mesh=mesh, **kwargs)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = fs._grad_epoch_call.launches - before

    def median_ms(phase):
        times = sorted(r.device_ms for r in rec.spans
                       if r.name == f"fused_train_scale_dp.{phase}" and r.device_ms is not None)
        return times[len(times) // 2] if times else None

    tile, dp = kwargs.get("tile", 2048), mesh.shape["data"]
    return {"params": to_numpy(params), "history": hist, "wall_s": wall,
            "k4_launches": launches, "k4_ms": median_ms("k4"),
            "allreduce_ms": median_ms("allreduce"),
            "block_rows": -(-len(windows) // (dp * tile)) * tile}


def dp_from(device, params, windows, **kwargs):
    """``fused_train_scale_dp(mesh=...)`` on ``windows`` from ``params``
    (numpy, e.g. the JAX package's initial params) → (params, history)."""
    from ..ops.fused_scale import fused_train_scale_dp
    from ..train.checkpoint import params_from_numpy

    mesh = create_mesh(device=device)
    return to_numpy(fused_train_scale_dp(
        windows, mesh=mesh, _init_params=params_from_numpy(params, mesh.device),
        **kwargs))


def gloo_cuda_probe(device):
    """Which collectives this world's backend takes on a tensor of
    ``device``: {"all_reduce", "broadcast", "all_gather"} → "ok" (the
    result checked), "wrong result" or the error's first line; and
    "entry", "joined", "entered": this rank's clock when its target began,
    when it had joined the group, and when this program began."""
    import torch.distributed as dist

    from .launch import rank_clock

    entered = time.time()
    mesh = create_mesh(device=device)
    rank, world = dist.get_rank(), dist.get_world_size()
    t = torch.full((4,), float(rank + 1), device=mesh.device)

    def all_reduce():
        x = t.clone()
        dist.all_reduce(x)
        return bool((x == world * (world + 1) / 2).all())

    def broadcast():
        x = t.clone()
        dist.broadcast(x, src=0)
        return bool((x == 1.0).all())

    def all_gather():
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        return all(bool((p == i + 1).all()) for i, p in enumerate(parts))

    out = {**rank_clock, "entered": entered}
    for name, fn in (("all_reduce", all_reduce), ("broadcast", broadcast),
                     ("all_gather", all_gather)):
        try:
            out[name] = "ok" if fn() else "wrong result"
        except Exception as e:  # the finding is the message
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0] if str(e) else ''}"
    dist.barrier()
    return out


def timed(device, fn, *args, **kwargs):
    """(wall seconds, ``fn(device, *args, **kwargs)``), the device synchronized."""
    t0 = time.perf_counter()
    out = fn(device, *args, **kwargs)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.perf_counter() - t0, out
