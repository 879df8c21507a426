"""The MPC tracker's step kernels (``csrc/mpc_step.cu``) and their plain
mirror.

An LM iteration of ``control/mpc.py::_Problem.solve`` runs as three
launches: :func:`form` (the rollout, the residual and its cost, J from its
structure, H = JᵀJ + λI and g = Jᵀr), ``ops/lu_solve.py::lu_solve`` (its
own launch), then :func:`update` (the clipped trial step, its cost, the
accept, λ; on the step's last iteration the first control applied to the
state).  The kernels replace no Pallas kernel: JAX's tracker is plain XLA.

The plain versions (:func:`_form_plain`, :func:`_update_plain`) are the
kernels' arithmetic written out in torch: the same products and sums in
the same order (the kernels are built with ``-fmad=false``; L's division
is a product by its float32 reciprocal, as torch divides by a scalar on
the card).  They are not ``_Problem``'s ops: H and g are formed from J's
structure rather than as ``Jt @ J`` (their sums over the track rows in
index order), the prefix sums are a warp's Kogge-Stone scans and the cost
a warp's reduction.
``control/mpc.py::_simulate_eager`` stays the torch step, the kernels'
plain version of the whole step; the mirror is what the tests hold the
kernels' arithmetic by.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it runs the mirror.  A shape past the kernels' bounds (:data:`PMAX`,
:data:`MMAX`) raises on either.  A captured graph launches the kernels at
each replay without running the wrappers, so each kernel counts its own
runs on the device: :func:`launches`, :func:`reset_launches`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

# the kernels (csrc/mpc_step.cu's d_mpc_launches order) and the bounds on
# the horizons (its PMAX, MMAX)
KERNELS = ("form", "update")
PMAX, MMAX = 64, 32


@dataclasses.dataclass(frozen=True)
class Consts:
    """A configuration's constants as the kernels take them: each a float32
    value, so that the mirror's torch ops and the kernels see the same
    numbers."""
    dt: float
    inv_l: float  # float32(1) / float32(wheelbase)
    max_accel: float
    max_steer: float
    w_th: float   # sqrt(q), sqrt(qf): the track rows' weights
    w_v: float
    wf_th: float
    wf_v: float
    sr_a: float   # sqrt(r): the Δu rows' weights
    sr_d: float
    lam0: float
    P: int
    M: int

    @classmethod
    def of(cls, cfg) -> "Consts":
        """From an ``MPCConfig``; the weights as ``_Problem`` takes them
        (float32 square roots)."""
        f = np.float32
        sq, sqf, sr = (np.sqrt(np.asarray(v, f)) for v in (cfg.q, cfg.qf, cfg.r))
        return cls(dt=float(f(cfg.dt)), inv_l=float(f(1) / f(cfg.wheelbase)),
                   max_accel=float(f(cfg.max_accel)), max_steer=float(f(cfg.max_steer)),
                   w_th=float(sq[0]), w_v=float(sq[1]), wf_th=float(sqf[0]),
                   wf_v=float(sqf[1]), sr_a=float(sr[0]), sr_d=float(sr[1]),
                   lam0=float(f(cfg.lm_lambda)), P=cfg.prediction_horizon,
                   M=cfg.control_horizon)


def check_bounds(P: int, M: int) -> None:
    """Raise where the kernels do not take horizons (P, M)."""
    if not (1 <= M <= P <= PMAX and M <= MMAX):
        raise ValueError(f"the MPC step kernels take 1 <= M <= P, P <= {PMAX} and M <= {MMAX}; "
                         f"got (P, M) = ({P}, {M})")


def _check(k: Consts, tensors: dict) -> str:
    """Check each named tensor's dtype, shape, contiguity and device → the
    device type ("cpu" or "cuda") they share."""
    check_bounds(k.P, k.M)
    devs = set()
    for name, (t, shape, dtype) in tensors.items():
        if t.dtype != dtype:
            raise ValueError(f"mpc_step: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"mpc_step: {name} must have shape {shape} at (P, M) = "
                             f"({k.P}, {k.M}), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"mpc_step: {name} must be contiguous")
        devs.add(t.device)
    dev = devs.pop()
    if devs or dev.type not in ("cpu", "cuda"):
        raise ValueError(f"mpc_step runs on CUDA or (plain) CPU tensors, all on one device; "
                         f"got {sorted(map(str, devs | {dev}))}")
    return dev.type


def _shapes(k: Consts, B: int) -> dict:
    n, f32 = 2 * k.M, torch.float32
    return {"u": ((B, k.M, 2), f32), "state": ((B, 4), f32), "ref": ((B, k.P + 1, 2), f32),
            "last": ((B, 2), f32), "first": ((B,), torch.int32), "lam": ((B,), f32),
            "cost0": ((B,), f32), "H": ((B, n, n), f32), "g": ((B, n, 1), f32),
            "x": ((B, n, 1), f32)}


def _launch(kernel: str, fn, *args) -> None:
    err = fn(*args, torch._C._cuda_getCurrentRawStream(torch.cuda.current_device()))
    if err:
        raise RuntimeError(f"mpc_step's {kernel} kernel failed to launch: CUDA error {err}")


def form(u, state, ref, last, first, lam, H, g, cost0, k: Consts, it: int,
         freeze: bool) -> None:
    """LM iteration ``it``'s H (B, 2M, 2M), g (B, 2M, 1) and cost0 (B,),
    written in place, from the iterate u (B, M, 2), state (B, 4), the
    step's reference rows ref (B, P+1, 2), the last applied control (B, 2),
    the rows' first-solve flags (B,) int32 and λ (B,) (``k.lam0`` at
    iteration 0); with ``freeze`` J is the warm start's [last, 0, …]."""
    spec = _shapes(k, u.shape[0])
    names = dict(u=u, state=state, ref=ref, last=last, first=first, lam=lam, H=H, g=g,
                 cost0=cost0)
    if _check(k, {n: (t, *spec[n]) for n, t in names.items()}) == "cpu":
        return _form_plain(u, state, ref, last, first, lam, H, g, cost0, k, it, freeze)
    from ._build import MpcConsts, load

    with torch.cuda.device(u.device):
        _launch("form", load("mpc_step").mpc_form, *(t.data_ptr() for t in names.values()),
                u.shape[0], MpcConsts(**dataclasses.asdict(k)), it, int(freeze))


def update(x, u, state, ref, last, first, lam, cost0, k: Consts, it: int, apply: bool) -> None:
    """LM iteration ``it``'s update, in place, from the LU kernel's x (B,
    2M, 1): u ← the clipped trial u − x where its cost is below cost0, λ
    halved or quadrupled; with ``apply`` (the step's last iteration) u[:, 0]
    applied: state Euler-stepped, last, the flags cleared, u ← [last, 0, …]."""
    spec = _shapes(k, u.shape[0])
    names = dict(x=x, u=u, state=state, ref=ref, last=last, first=first, lam=lam, cost0=cost0)
    if _check(k, {n: (t, *spec[n]) for n, t in names.items()}) == "cpu":
        return _update_plain(x, u, state, ref, last, first, lam, cost0, k, it, apply)
    from ._build import MpcConsts, load

    with torch.cuda.device(u.device):
        _launch("update", load("mpc_step").mpc_update, *(t.data_ptr() for t in names.values()),
                u.shape[0], MpcConsts(**dataclasses.asdict(k)), it, int(apply))


def launches(device, kernel: Optional[str] = None) -> int:
    """The kernels' runs on ``device`` since the last reset, graph replays
    included, read once the device's work is done: ``kernel``'s, or both."""
    from ._build import load

    if kernel is not None and kernel not in KERNELS:
        raise ValueError(f"mpc_step's kernels are {KERNELS}, got {kernel!r}")
    dev = torch.device(device)
    out = (ctypes.c_ulonglong * len(KERNELS))()
    with torch.cuda.device(dev):
        torch.cuda.synchronize(dev)
        err = load("mpc_step").mpc_step_launches(out)
    if err:
        raise RuntimeError(f"reading mpc_step's launch counts failed: CUDA error {err}")
    return int(sum(out) if kernel is None else out[KERNELS.index(kernel)])


def reset_launches(device) -> None:
    from ._build import load

    dev = torch.device(device)
    with torch.cuda.device(dev):
        torch.cuda.synchronize(dev)
        err = load("mpc_step").mpc_step_reset_launches()
    if err:
        raise RuntimeError(f"resetting mpc_step's launch counts failed: CUDA error {err}")


# ---- the plain mirror: the kernels' arithmetic in torch ----------------------

def _held(w: torch.Tensor, k: Consts) -> torch.Tensor:
    """(B, M, 2) → (B, P, 2): input s driven by control row min(s, M − 1)."""
    return w[:, torch.clamp(torch.arange(k.P, device=w.device), max=k.M - 1)]


def _scan(x: torch.Tensor) -> torch.Tensor:
    """(B, N ≤ 64) → its inclusive prefix sums as one warp takes them
    (``warp_scan`` in the source): a Kogge-Stone scan of each half of 32
    (entry l adds entry l − o's running sum, o = 1, 2, 4, 8, 16), then the
    first half's total added to the second half's sums."""
    B, N = x.shape
    v = torch.cat([x, x.new_zeros((B, 64 - N))], dim=1).reshape(B, 2, 32)
    for o in (1, 2, 4, 8, 16):
        v = torch.cat([v[..., :o], v[..., o:] + v[..., :-o]], dim=-1)
    v = torch.stack([v[:, 0], v[:, 0, 31:] + v[:, 1]], dim=1)
    return v.reshape(B, 64)[:, :N]


def _from(x0: torch.Tensor, incr: torch.Tensor) -> torch.Tensor:
    """[x0, x0 + Σ_{s<1} incr, …, x0 + Σ_{s<N} incr] (B, N + 1)."""
    return torch.cat([x0[:, None], x0[:, None] + _scan(incr)], dim=1)


def _rollout(k: Consts, w, th0, v0, theta: bool = True):
    """tan(clip(δ)) (B, P), v (B, P+1) and θ (B, P+1) of the Euler rollout
    of controls w (B, M, 2), as ``rollout`` in the source."""
    wf = _held(w, k)
    adt = torch.clamp(wf[..., 0], -k.max_accel, k.max_accel) * k.dt
    tn = torch.tan(torch.clamp(wf[..., 1], -k.max_steer, k.max_steer))
    v = _from(v0, adt)
    if not theta:
        return tn, v, None
    return tn, v, _from(th0, v[:, :-1] * tn * k.inv_l * k.dt)


def _track_weights(k: Consts, dev):
    """(P+1, 2): sqrt(q) on rows 0..P−1, sqrt(qf) on row P."""
    return torch.tensor([[k.w_th, k.w_v]] * k.P + [[k.wf_th, k.wf_v]], dtype=torch.float32,
                        device=dev)


def _residuals(k: Consts, w, th, v, ref, last, first):
    """The residual vector (B, 2(P+1) + 2M), as ``residuals`` in the source."""
    B = w.shape[0]
    track = (torch.stack([th, v], dim=-1) - ref) * _track_weights(k, w.device)
    prev = torch.cat([last[:, None], w[:, :-1]], dim=1)
    sr = torch.tensor([k.sr_a, k.sr_d], dtype=torch.float32, device=w.device)
    wi = torch.ones((B, k.M), dtype=torch.float32, device=w.device)
    wi[:, 0] = torch.where(first, 0.0, 1.0)
    du = (w - prev) * sr * wi[..., None]
    return torch.cat([track.reshape(B, -1), du.reshape(B, -1)], dim=1)


def _sum_sq(r: torch.Tensor) -> torch.Tensor:
    """Σ r² as one warp sums it (``warp_sum_sq`` in the source): lane l
    adds r_l², r_{l+32}², … in order, then a butterfly adds the lanes."""
    B, R = r.shape
    pad = torch.zeros((B, -R % 32), dtype=r.dtype, device=r.device)
    sq = torch.cat([r, pad], dim=1).reshape(B, -1, 32)
    lanes = torch.zeros((B, 32), dtype=r.dtype, device=r.device)
    for m in range(sq.shape[1]):
        lanes = lanes + sq[:, m] * sq[:, m]
    idx = torch.arange(32, device=r.device)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, idx ^ o]
    return lanes[:, 0]


def _clip_deriv(x: torch.Tensor, b: float) -> torch.Tensor:
    a = x.abs()
    return torch.where(a < b, 1.0, torch.where(a == b, 0.5, 0.0))


def _jacobian(k: Consts, uj, tn, v):
    """J's track rows at controls uj from their rollout (tan δ, v): θ rows
    (B, P+1, 2M) and v rows (B, P+1, 2M, zero in the δ columns), as the
    source writes J from its structure."""
    B, P, M, dev = uj.shape[0], k.P, k.M, uj.device
    uf = _held(uj, k)
    A = k.dt * _clip_deriv(uf[..., 0], k.max_accel)
    D = v[:, :-1] * (1.0 + tn * tn) * _clip_deriv(uf[..., 1], k.max_steer) * k.inv_l * k.dt
    kk = torch.cat([torch.zeros_like(tn[:, :1]), _scan(tn * k.inv_l * k.dt)], dim=1)
    t = torch.arange(P + 1, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    # columns j < M − 1: nonzero for t > j
    below = t[:, None] > torch.arange(M - 1, device=dev)[None, :]
    ja = torch.where(below, A[:, None, :M - 1] * (kk[:, :, None] - kk[:, None, 1:M]), zero)
    jd = torch.where(below, D[:, None, :M - 1], zero)
    jv = torch.where(below, A[:, None, :M - 1], zero)
    # the held column: s = M − 1 .. t − 1 in order
    ha = hd = hv = torch.zeros((B, P + 1), dtype=torch.float32, device=dev)
    for s in range(M - 1, P):
        on = t > s
        ha = torch.where(on, ha + A[:, s:s + 1] * (kk - kk[:, s + 1:s + 2]), ha)
        hd = torch.where(on, hd + D[:, s:s + 1], hd)
        hv = torch.where(on, hv + A[:, s:s + 1], hv)
    w = _track_weights(k, dev)
    Jth = torch.zeros((B, P + 1, 2 * M), dtype=torch.float32, device=dev)
    Jth[:, :, 0::2] = torch.cat([ja, ha[..., None]], dim=2) * w[None, :, 0:1]
    Jth[:, :, 1::2] = torch.cat([jd, hd[..., None]], dim=2) * w[None, :, 0:1]
    Jv = torch.zeros_like(Jth)
    Jv[:, :, 0::2] = torch.cat([jv, hv[..., None]], dim=2) * w[None, :, 1:2]
    return Jth, Jv


def _form_plain(u, state, ref, last, first, lam, H, g, cost0, k: Consts, it: int,
                freeze: bool) -> None:
    B, P, M, n, dev = u.shape[0], k.P, k.M, 2 * k.M, u.device
    fst = first != 0
    th0, v0 = state[:, 2], state[:, 3]
    tn, v, th = _rollout(k, u, th0, v0)
    r = _residuals(k, u, th, v, ref, last, fst)
    cost = _sum_sq(r)
    if freeze and it > 0:
        uj = torch.zeros_like(u)
        uj[:, 0] = last
        tnj, vj, _ = _rollout(k, uj, th0, v0, theta=False)
        Jth, Jv = _jacobian(k, uj, tnj, vj)
    else:
        Jth, Jv = _jacobian(k, u, tn, v)
    # H: the track rows in order, then the Δu rows' products, then λ
    acc = torch.zeros((B, n, n), dtype=torch.float32, device=dev)
    for t in range(P + 1):
        acc = acc + Jth[:, t, :, None] * Jth[:, t, None, :]
        acc = acc + Jv[:, t, :, None] * Jv[:, t, None, :]
    sr = torch.tensor([k.sr_a, k.sr_d] * M, dtype=torch.float32, device=dev)
    rr = sr * sr
    col = torch.arange(n, device=dev)
    free0 = (col[None, :] < 2) & fst[:, None]  # row 0's weight 0 on a first solve
    lm = lam if it else torch.full((B,), k.lam0, dtype=torch.float32, device=dev)
    diag = acc.diagonal(dim1=1, dim2=2)
    diag = torch.where(free0, diag, diag + rr)
    diag = torch.where(col < n - 2, diag + rr, diag)
    diag = diag + lm[:, None]
    up = acc.diagonal(offset=2, dim1=1, dim2=2) + (-sr[:n - 2]) * sr[:n - 2]
    acc[:, col, col] = diag
    acc[:, col[:n - 2], col[:n - 2] + 2] = up
    acc[:, col[:n - 2] + 2, col[:n - 2]] = up
    # g: the track rows in order, then the Δu rows
    gacc = torch.zeros((B, n), dtype=torch.float32, device=dev)
    for t in range(P + 1):
        gacc = gacc + Jth[:, t] * r[:, 2 * t:2 * t + 1]
        gacc = gacc + Jv[:, t] * r[:, 2 * t + 1:2 * t + 2]
    rdu = r[:, 2 * (P + 1):]
    gacc = torch.where(free0, gacc, gacc + sr * rdu)
    gacc[:, :n - 2] = gacc[:, :n - 2] + (-sr[:n - 2]) * rdu[:, 2:]
    H.copy_(acc)
    g.copy_(gacc[..., None])
    cost0.copy_(cost)


def _update_plain(x, u, state, ref, last, first, lam, cost0, k: Consts, it: int,
                  apply: bool) -> None:
    B, M, dev = u.shape[0], k.M, u.device
    bound = torch.tensor([k.max_accel, k.max_steer], dtype=torch.float32, device=dev)
    ut = torch.minimum(torch.maximum(u + -x.reshape(B, M, 2), -bound), bound)
    fst = first != 0
    tn, v, th = _rollout(k, ut, state[:, 2], state[:, 3])
    accept = _sum_sq(_residuals(k, ut, th, v, ref, last, fst)) < cost0
    un = torch.where(accept[:, None, None], ut, u)
    lm = lam if it else torch.full((B,), k.lam0, dtype=torch.float32, device=dev)
    lam.copy_(torch.clamp(torch.where(accept, lm * 0.5, lm * 4.0), 1e-8, 1e4))
    if not apply:
        u.copy_(un)
        return
    la = un[:, 0]
    px, py, th0, v0 = state.unbind(1)
    a = torch.clamp(la[:, 0], -k.max_accel, k.max_accel)
    d = torch.clamp(la[:, 1], -k.max_steer, k.max_steer)
    state.copy_(torch.stack([px + v0 * torch.cos(th0) * k.dt, py + v0 * torch.sin(th0) * k.dt,
                             th0 + v0 * torch.tan(d) * k.inv_l * k.dt, v0 + a * k.dt], dim=1))
    last.copy_(la)
    first.zero_()
    u.zero_()
    u[:, 0] = la
