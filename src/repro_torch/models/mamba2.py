"""Mamba2 — the SSD (state-space duality) mixer, chunked-scan formulation.

The port's counterpart of ``repro.models.mamba2``.  The sequence is cut
into chunks of ``chunk`` tokens: within a chunk the SSD dual form is a
masked, decay-weighted quadratic attention; across chunks one
(B, H, P, N) state is carried — O(S) work, O(1) decode state.  The mixer
is the reference's: projections stored per role (``wz/wx/wB/wC/wdt``), the
causal conv over x only, the gated RMSNorm over (H, P).

:func:`ssd_block` runs the scan through
:func:`repro_torch.kernels.ssd.ssd_scan` — the CUDA kernel on the card,
its plain version on the CPU, as the reference's ``impl="pallas"`` does —
and can return the exact decode state after each prompt's last real
token, which the reference's prefill does not (``repro/models/lm.py``,
``TODO(ssm prefill)``).  :func:`ssd_scan` is the reference's chunked form
in plain PyTorch, which training differentiates, as the reference trains
through it (its ``ssd_impl`` defaults to ``"ref"``; neither package's
kernel has a backward).

Tensor parallelism (the reference's rules: ``ssm_heads`` over ``model``):
under sharding rules that split the heads, a rank holds its heads' blocks
of ``wz``, ``wx``, ``wdt``, ``dt_bias``, ``A_log``, ``D_skip``, ``conv_x``,
``norm_scale`` and ``wo``, and ``wB``/``wC`` whole (one group, shared by
every head).  The heads' products are column-parallel (their input's
gradient summed over ``model``), ``B`` and ``C`` are computed whole on
every rank and their gradients summed over ``model`` (each rank's heads
add a part), the gated norm's sum of squares over (H, P) is all-reduced,
its gradient too, and ``wo`` is row-parallel (its output summed), where
GSPMD places the same collectives in the reference.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import sharding
from repro_torch.kernels.ssd import ssd_scan as ssd_kernel
from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class SSDCfg:
    d_model: int
    n_heads: int              # d_inner // headdim
    headdim: int = 64
    d_state: int = 128
    d_conv: int = 4
    chunk: int = 256
    ngroups: int = 1

    @property
    def d_inner(self) -> int:
        return self.n_heads * self.headdim


def init_ssd(gen, cfg: SSDCfg, dtype, device, lead: tuple = ()) -> dict:
    """Random projections and conv from ``gen``; the reference's
    deterministic leaves: ``A_log = log(linspace(1, 16, H))``, ``dt_bias``
    0, ``D_skip`` 1 (all f32) and ``norm_scale`` 1."""
    D, H, P, G, N = (cfg.d_model, cfg.n_heads, cfg.headdim, cfg.ngroups,
                     cfg.d_state)
    f32 = torch.float32
    A_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=f32, device=device))
    return {
        "wz": layers.dense_init(gen, D, lead + (D, H, P), dtype, device),
        "wx": layers.dense_init(gen, D, lead + (D, H, P), dtype, device),
        "wB": layers.dense_init(gen, D, lead + (D, G, N), dtype, device),
        "wC": layers.dense_init(gen, D, lead + (D, G, N), dtype, device),
        "wdt": layers.dense_init(gen, D, lead + (D, H), dtype, device),
        "dt_bias": torch.zeros(lead + (H,), dtype=f32, device=device),
        "A_log": A_log.expand(lead + (H,)).clone(),
        "D_skip": torch.ones(lead + (H,), dtype=f32, device=device),
        "conv_x": layers.normal(gen, lead + (H, P, cfg.d_conv), dtype,
                                device, 0.1),
        "norm_scale": torch.ones(lead + (H, P), dtype=dtype, device=device),
        "wo": layers.dense_init(gen, cfg.d_inner, lead + (H, P, D), dtype,
                                device),
    }


def axes_ssd() -> dict:
    """Each leaf's logical dims, the reference's ``axes_ssd``."""
    return {"wz": ("embed", "ssm_heads", None),
            "wx": ("embed", "ssm_heads", None),
            "wB": ("embed", None, "state"),
            "wC": ("embed", None, "state"),
            "wdt": ("embed", "ssm_heads"),
            "dt_bias": ("ssm_heads",),
            "A_log": ("ssm_heads",),
            "D_skip": ("ssm_heads",),
            "conv_x": ("ssm_heads", None, None),
            "norm_scale": ("ssm_heads", None),
            "wo": ("ssm_heads", None, "embed")}


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, H, P), kernel: (H, P, W)."""
    W = kernel.shape[-1]
    out = x * kernel[..., -1]
    for i in range(1, W):
        shifted = F.pad(x, (0, 0, 0, 0, i, 0))[:, :x.shape[1]]
        out = out + shifted * kernel[..., -1 - i]
    return out


def sum_over_heads(t: torch.Tensor, split) -> torch.Tensor:
    """``t``, a partial sum over this rank's heads, summed over the
    split's group; its gradient is summed too (every rank's heads read the
    total)."""
    return sharding.reduce_from(sharding.copy_to(t, split), split)


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6, split=None) -> torch.Tensor:
    """Mamba2's gated norm over the full d_inner = (H, P) dims; with the
    heads split, over every rank's heads (:func:`sum_over_heads`)."""
    g = y * F.silu(z.float()).to(y.dtype)
    gf = g.float()
    if split is None:
        var = torch.mean(gf * gf, dim=(-2, -1), keepdim=True)
    else:
        ss = sum_over_heads((gf * gf).sum(dim=(-2, -1), keepdim=True),
                            split)
        var = ss / (gf.shape[-2] * split.n * gf.shape[-1])
    return (gf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) → (..., T, T) lower-triangular segment sums (f32, -inf
    above the diagonal): ``seg[i, j] = Σ_{k=j+1..i} a_k``."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((T, T), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, seg, torch.full_like(seg, float("-inf")))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
             h0: torch.Tensor | None = None):
    """The reference's chunked SSD forward (``repro.models.mamba2.
    ssd_scan``), differentiable.  x: (B, S, H, P), dt: (B, S, H)
    post-softplus, A: (H,) negative, Bm/Cm: (B, S, G, N) with G broadcast
    over heads → y (B, S, H, P) f32 and the final state (B, H, P, N)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = max(S // chunk, 1)
    Q = S // L
    rep = H // G

    dA = (dt * A[None, None, :]).float()                          # (B,S,H)
    xd = x * dt[..., None].to(x.dtype)                            # dt-weighted
    xc = xd.reshape(Bsz, L, Q, H, P).float()
    Bc = Bm.reshape(Bsz, L, Q, G, N).repeat_interleave(rep, dim=3).float()
    Cc = Cm.reshape(Bsz, L, Q, G, N).repeat_interleave(rep, dim=3).float()
    dAc = dA.reshape(Bsz, L, Q, H).permute(0, 3, 1, 2)            # (B,H,L,Q)
    A_cum = torch.cumsum(dAc, dim=-1)

    # intra-chunk (dual quadratic form)
    Lmat = torch.exp(_segsum(dAc))                                # (B,H,L,Q,Q)
    scores = torch.einsum("blqhn,blshn->bhlqs", Cc, Bc)
    y_diag = torch.einsum("bhlqs,bhlqs,blshp->blqhp", scores, Lmat, xc)

    # chunk states, then the inter-chunk recurrence
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)             # (B,H,L,Q)
    states = torch.einsum("blqhn,bhlq,blqhp->blhpn", Bc, decay_states, xc)
    chunk_decay = torch.exp(A_cum[..., -1])                       # (B,H,L)
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    h_prev = []
    for c in range(L):
        h_prev.append(h)                       # the state *before* chunk c
        h = h * chunk_decay[:, :, c, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                           # (B,L,H,P,N)

    # the carried state's contribution to each position
    y_off = torch.einsum("blqhn,blhpn,bhlq->blqhp", Cc, h_prev,
                         torch.exp(A_cum))
    return (y_diag + y_off).reshape(Bsz, S, H, P), h


def _project(params: dict, x: torch.Tensor, split=None):
    """x (..., D) → z, xi (..., H, P), Bm, Cm (..., G, N) in the activation
    dtype, and dt (..., H) in f32 after its softplus; H is this rank's
    heads where ``split`` splits them."""
    lead = x.shape[:-1]
    xs = sharding.copy_to(x, split)    # the heads' column-parallel input

    def proj(inp, w):
        return (inp @ w.to(x.dtype).reshape(x.shape[-1], -1)).reshape(
            *lead, *w.shape[1:])

    z = proj(xs, params["wz"])
    xi = proj(xs, params["wx"])
    Bm = sharding.copy_to(proj(x, params["wB"]), split)
    Cm = sharding.copy_to(proj(x, params["wC"]), split)
    dt = F.softplus(xs.float() @ params["wdt"].float()
                    + params["dt_bias"].float())
    return z, xi, Bm, Cm, dt


def _output(params: dict, y: torch.Tensor, xi: torch.Tensor,
            z: torch.Tensor, dtype, split=None) -> torch.Tensor:
    """The skip, the gated norm and the out-projection: y (..., H, P) in
    f32 → (..., D) in ``dtype`` (row-parallel over a split's heads)."""
    y = y.to(dtype) + params["D_skip"].to(dtype)[:, None] * xi
    y = _gated_rmsnorm(y, z, params["norm_scale"], split=split).to(dtype)
    wo = params["wo"].to(dtype)
    return sharding.reduce_from(y.flatten(-2) @ wo.reshape(-1, wo.shape[-1]),
                                split)


def ssd_block(params: dict, x: torch.Tensor, cfg: SSDCfg,
              last_idx: torch.Tensor | None = None,
              return_state: bool = False, differentiable: bool = False):
    """The mamba2 mixer. x: (B, S, D) → (B, S, D), and with
    ``return_state`` the decode state ``{"h": (B, H, P, N) f32, "conv":
    (B, d_conv − 1, H, P)}`` (this rank's heads) after position
    ``last_idx`` (B,) (default S − 1).  The scan is the SSD kernel, or
    with ``differentiable`` (training) :func:`ssd_scan`.  dt is zeroed
    past ``last_idx``, so pad positions leave the state as it is
    (``exp(0·A) = 1``, ``0·x = 0``) and real positions' outputs do not
    change; ``conv`` holds the pre-conv inputs at
    ``last_idx − d_conv + 2 … last_idx`` (zeros before position 0), as
    :func:`ssd_decode_step` keeps them."""
    B, S, _ = x.shape
    split = sharding.split_of("ssm_heads", cfg.n_heads)
    z, xi_pre, Bm, Cm, dt = _project(params, x, split)
    xi = F.silu(_causal_conv(xi_pre, params["conv_x"].to(x.dtype)))
    if last_idx is not None:
        pos = torch.arange(S, device=x.device)
        dt = torch.where(pos[None, :, None] > last_idx[:, None, None],
                         torch.zeros_like(dt), dt)
    A = -torch.exp(params["A_log"].float())
    scan = ssd_scan if differentiable else ssd_kernel
    y, h = scan(xi, dt, A, Bm, Cm, chunk=min(cfg.chunk, S))
    out = _output(params, y, xi, z, x.dtype, split)
    if not return_state:
        return out
    W = cfg.d_conv - 1
    last = (torch.full((B,), S - 1, device=x.device) if last_idx is None
            else last_idx.to(device=x.device, dtype=torch.long))
    # padded row t + W holds xi_pre[t]; rows last+1 … last+W are the tail
    idx = last[:, None] + 1 + torch.arange(W, device=x.device)    # (B, W)
    padded = F.pad(xi_pre, (0, 0, 0, 0, W, 0))
    conv = padded[torch.arange(B, device=x.device)[:, None], idx]
    return out, {"h": h, "conv": conv}


# ---------------------------------------------------------------------------
# O(1)-state decode
# ---------------------------------------------------------------------------

def init_ssd_state(batch: int, cfg: SSDCfg, dtype, device,
                   lead: tuple = ()) -> dict:
    """``h`` (…, B, H, P, N) f32 and ``conv`` (…, B, d_conv − 1, H, P) in
    ``dtype``, zero."""
    H, P = cfg.n_heads, cfg.headdim
    return {
        "h": torch.zeros(lead + (batch, H, P, cfg.d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, cfg.d_conv - 1, H, P),
                            dtype=dtype, device=device),
    }


def axes_ssd_state() -> dict:
    """The decode state's logical dims, the reference's
    ``axes_ssd_state``."""
    return {"h": ("batch", "ssm_heads", None, None),
            "conv": ("batch", None, "ssm_heads", None)}


def ssd_decode_step(params: dict, x: torch.Tensor, state: dict,
                    cfg: SSDCfg) -> torch.Tensor:
    """x: (B, D), one token → y (B, D); ``state`` ({"h", "conv"}, this
    rank's heads) is advanced in place."""
    split = sharding.split_of("ssm_heads", cfg.n_heads)
    z, xi, Bm, Cm, dt = _project(params, x, split)
    # the rolling causal conv over the last d_conv pre-conv inputs
    hist = torch.cat([state["conv"], xi[:, None].to(state["conv"].dtype)],
                     dim=1)                                       # (B,W,H,P)
    k = params["conv_x"].to(x.dtype)                              # (H,P,W)
    xi = torch.einsum("bwhp,hpw->bhp", hist.float(), k.float()).to(x.dtype)
    xi = F.silu(xi)
    state["conv"].copy_(hist[:, 1:])

    A = -torch.exp(params["A_log"].float())
    rep = xi.shape[1] // Bm.shape[1]
    Bh = Bm.repeat_interleave(rep, dim=1).float()                 # (B,H,N)
    Ch = Cm.repeat_interleave(rep, dim=1).float()
    h = state["h"]
    h.mul_(torch.exp(dt * A)[..., None, None]).add_(
        dt[..., None, None] * Bh[:, :, None, :] * xi[..., None].float())
    y = torch.einsum("bhpn,bhn->bhp", h, Ch)
    return _output(params, y, xi, z, x.dtype, split)
