"""Plain replay of a recorded frame: the PyTorch version of the backward
kernel (tracer/pallas/bwd.py:_bwd_kernel, `_bounce_fn` and the shared
`_shade` of tracer/pallas/kernel_lib.py).

Per pixel and sample, the primary ray is regenerated from the seed
streams; each bounce gathers its RECORDED winner's column of the packed
table (tracer_torch.kernels.bwd.pack_bwd_tables, rows in kernels/pack.py),
recomputes t from the winner's geometry (near root with far fallback, or
the plane root; the tape already proved the winner valid), and shades
with the same draws, roulette and texture tape as the recording kernel. `torch.autograd.grad`
of the replayed frame against the packed table, the camera rows and (with
13 tape fields) the recorded texel values gives the backward kernel's
outputs by construction: (dtable, dcam, fb, gtex).

The replay rounds as the backward kernel does, so that a path whose
gradient is ill-conditioned (a refraction near total internal reflection
ahead of a long hop onto a noisy texture) gets the same gradient from
both: inner products summed x, y, z in that order, `1 / sqrt` for the
unit direction, and Schlick's fifth power as `x2 * x2 * x`.

With a 9- or 13-field texture tape the texel is linearised around the
recorded hit, `mult = T + dT/du (u - sg u) + dT/dv (v - sg v)`: the value
is the recorded texel, the gradient carries d(texel)/d(uv). u and v are
recomputed from the hit point: planes from their A/B frame rows, spheres
from the outward normal with atan2/acos (analytic derivatives; pole and
off-case lanes get constant inputs, so derivative 0).
"""

from __future__ import annotations

import math

import torch

from tracer_torch.core import rng, vec
from tracer_torch.kernels import pack as J
from tracer_torch.materials.scatter import max3
from tracer_torch.render.integrator import roulette_p
from tracer_torch.scene.types import K_INFINITY

T_MIN, T_MAX = 1e-3, 1e30
DENOM_EPS = 1e-8
DEFAULT_CHUNK = 16384


def _mx(a, b):
    """maximum with a Python-float side, gradient split at ties (jnp.maximum)."""
    return torch.maximum(a, a.new_tensor(b))


def _mn(a, b):
    return torch.minimum(a, a.new_tensor(b))


def _dot(a, b):
    """Inner product over the trailing xyz axis, summed as the kernel sums it."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _bounce(rec, bg, state, hit, seed, alive, tm, tm3, rr_start, depth):
    """One differentiable replay bounce (bwd.py:_bounce_fn + kernel_lib.py:
    _shade) over `[n]` lanes. `rec` is the winner's table column `[TROWS,
    n]` (zero on misses), `state` = (o, d, beta, final) `[n, 3]` each.
    Returns (state, seed, live)."""
    o, d, beta, final = state
    row = lambda r: rec[r]
    # miss-lane sanitisation (bwd.py:441-445)
    rad = torch.where(hit, row(J.J_RAD), 1.0)
    ir = torch.where(hit, row(J.J_IR), 1.0)
    pn = torch.stack([row(J.J_NX), row(J.J_NY), torch.where(hit, row(J.J_NZ), 1.0)], dim=-1)
    c = torch.stack([row(J.J_CX), row(J.J_CY), row(J.J_CZ)], dim=-1)
    is_sph = row(J.J_ISSPH) > 0.5
    pd = row(J.JROWS + J.G_PD)

    # t of the recorded winner (bwd.py:450-467)
    a = _dot(d, d)
    oc = o - c
    half_b = _dot(oc, d)
    c_q = _dot(oc, oc) - rad * rad
    disc = half_b * half_b - a * c_q
    dpos = disc >= 0.0
    sq = vec._sqrt_grad_safe(torch.where(dpos, disc, 1.0))
    inv_a = 1.0 / a
    t_near = (-half_b - sq) * inv_a
    near_ok = dpos & (t_near >= T_MIN) & (t_near <= T_MAX)
    t_s = torch.where(near_ok, t_near, (-half_b + sq) * inv_a)
    denom = _dot(pn, d)
    safe_denom = torch.where(torch.abs(denom) < DENOM_EPS, 1.0, denom)
    t_p = (pd - _dot(pn, o)) / safe_denom
    t = torch.where(hit, torch.where(is_sph, t_s, t_p), K_INFINITY)

    albedo = torch.stack([row(J.J_ALB0), row(J.J_ALB1), row(J.J_ALB2)], dim=-1)
    if tm is not None:
        textured = hit & (row(J.J_TEXID) > -0.5)
        if tm3 is not None:
            mult = torch.where(textured[..., None], tm3, 1.0)
        else:
            mult = tm[:, 0:3]
        t_hit = torch.where(hit, t, 1.0)
        h = o + t_hit[..., None] * d
        g = lambda r: rec[J.JROWS + r]
        u_p = g(J.G_AX) * h[:, 0] + g(J.G_AY) * h[:, 1] + g(J.G_AZ) * h[:, 2] - g(J.G_BA)
        v_p = g(J.G_BX) * h[:, 0] + g(J.G_BY) * h[:, 1] + g(J.G_BZ) * h[:, 2] - g(J.G_BB)
        sph_tex = textured & is_sph
        on = (h - c) * (1.0 / rad)[..., None]
        r2_ok = sph_tex & (on[:, 0] * on[:, 0] + on[:, 2] * on[:, 2] > 1e-12)
        onx = torch.where(r2_ok, on[:, 0], 1.0)
        onz = torch.where(r2_ok, on[:, 2], 0.0)
        ony = _mn(_mx(torch.where(sph_tex, on[:, 1], 0.0), -1.0 + 1e-6), 1.0 - 1e-6)
        u_s = (torch.atan2(-onz, onx) + math.pi) / (2.0 * math.pi)
        v_s = torch.acos(ony) / math.pi
        u_r = torch.where(is_sph, u_s, u_p)
        v_r = torch.where(is_sph, v_s, v_p)
        du = (u_r - u_r.detach())[..., None]
        dv = (v_r - v_r.detach())[..., None]
        mult = mult + tm[:, 3:6] * du + tm[:, 6:9] * dv
        albedo = albedo * mult

    # _shade (kernel_lib.py:724-963)
    hitr = t < K_INFINITY
    t_calc = torch.where(hitr, t, 1.0)
    p = o + t_calc[..., None] * d
    on = torch.where(is_sph[..., None], (p - c) * (1.0 / rad)[..., None], pn)
    front = _dot(d, on) < 0.0
    n = on * torch.where(front, 1.0, -1.0)[..., None]

    miss = alive & ~hitr
    final = final + torch.where(miss[..., None], beta * bg, 0.0)
    active = alive & hitr
    emit = torch.stack([row(J.J_EMI0), row(J.J_EMI1), row(J.J_EMI2)], dim=-1)
    final = final + torch.where(active[..., None], beta * emit, 0.0)

    seed, u_choice = rng.random_float(seed)
    seed, hemi = rng.random_unit_vector(seed)
    seed, ball = rng.random_in_unit_sphere(seed)
    seed, u_refl = rng.random_float(seed)
    seed, u_rr = rng.random_float(seed)
    hemi = hemi * torch.where(_dot(hemi, n) > 0.0, 1.0, -1.0)[..., None]

    ud = d * (1.0 / torch.sqrt(_mx(a, 1e-30)))[..., None]
    hemi_nz = (torch.abs(hemi) >= 1e-8).any(dim=-1)
    lam = torch.where(hemi_nz[..., None], hemi, n)
    uddn = _dot(ud, n)
    refl = ud - 2.0 * uddn[..., None] * n
    r = refl + row(J.J_FUZZ)[..., None] * ball
    spec = u_choice < 0.8
    met = torch.where(spec[..., None], r, lam)
    met_ok = ~spec | (_dot(r, n) > 0.0)

    ratio = torch.where(front, 1.0 / ir, ir)
    cos_t = _mn(-uddn, 1.0)
    sin_t = vec._sqrt_grad_safe(torch.maximum(cos_t.new_tensor(0.0), 1.0 - cos_t * cos_t))
    cannot = ratio * sin_t > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    x1 = 1.0 - cos_t
    x2 = x1 * x1
    refl_p = r0 + (1.0 - r0) * (x2 * x2 * x1)
    choose_refl = cannot | (refl_p > u_refl)
    perp = ratio[..., None] * (ud + cos_t[..., None] * n)
    par = -vec._sqrt_grad_safe(torch.abs(1.0 - _dot(perp, perp)))
    die = torch.where(choose_refl[..., None], refl, perp + par[..., None] * n)
    dist = vec._sqrt_grad_safe(_dot(p - o, p - o))
    ab = torch.stack([row(J.J_ABS0), row(J.J_ABS1), row(J.J_ABS2)], dim=-1)
    tr = torch.where(front[..., None], 1.0, torch.exp(-ab * dist[..., None]))
    p_rr = max3(tr)
    die_ok = u_rr <= p_rr
    da = tr * (1.0 / _mx(p_rr, 1e-30))[..., None]
    die_sgn = torch.where(_dot(die, n) > 0.0, 1e-4, -1e-4)
    die_o = p + n * die_sgn[..., None]

    mtype = row(J.J_MTYPE)
    is_lam, is_met, is_die = mtype == 0.0, mtype == 1.0, mtype == 2.0
    nd = torch.where(is_lam[..., None], lam, torch.where(is_met[..., None], met, die))
    no = torch.where(is_die[..., None], die_o, p)
    at = torch.where(is_die[..., None], da, albedo)
    ok = is_lam | (is_met & met_ok) | (is_die & die_ok)
    live = active & ok
    beta = torch.where(live[..., None], beta * at, beta)
    o = torch.where(live[..., None], no, o)
    d = torch.where(live[..., None], nd, d)

    if rr_start is not None:
        seed, u_t = rng.random_float(seed)
        pr = roulette_p(beta)
        do = live & (depth >= rr_start)
        kill = do & (u_t >= pr)
        beta = beta * torch.where(do & ~kill, 1.0 / pr, 1.0)[..., None]
        live = live & ~kill
    return (o, d, beta, final), seed, live


def replay_frame(table, camv, idx2, width: int, lin, spp: int, max_depth: int, *,
                 row_offset: int = 0, sample_start: int = 0, reference_quirk: bool = True,
                 rr_start=None, t2=None, tape_f: int = 0, tm3=None):
    """Replayed raw sample sums `[n, 3]` of the pixels `lin` (local linear
    ids of the band), differentiable in `table` `[TROWS, N]`, `camv` `[15]`
    and `tm3` (`[3*spp*D, n]`, the recorded texel values, or None).
    `idx2` `[spp*D, n]` and `t2` `[F*spp*D, n]` are the tapes' columns of
    these pixels."""
    i = lin % width
    j = lin // width + row_offset
    base = rng.pixel_seed(i, j, width, reference_quirk)
    fi, fj = i.to(torch.float32)[..., None], j.to(torch.float32)[..., None]
    p00, du, dv, o0, bg = camv[0:3], camv[3:6], camv[6:9], camv[9:12], camv[12:15]
    rows = spp * max_depth
    fb = torch.zeros((lin.shape[0], 3), dtype=torch.float32, device=lin.device)
    for s in range(spp):
        seed = rng.sample_seed(base, sample_start + s)
        seed, ux = rng.random_float(seed)
        seed, uy = rng.random_float(seed)
        pc = p00 + fi * du + fj * dv
        d = pc + (ux - 0.5)[..., None] * du + (uy - 0.5)[..., None] * dv - o0
        o = o0.expand_as(d)
        state = (o, d, torch.ones_like(d), torch.zeros_like(d))
        alive = torch.ones(lin.shape[0], dtype=torch.bool, device=lin.device)
        for depth in range(max_depth):
            if not bool(alive.any()):
                break
            slot = s * max_depth + depth
            w = idx2[slot].long()
            hit = w >= 0
            rec = torch.where(hit, table[:, w.clamp(min=0)], 0.0)
            tm = None
            if t2 is not None:
                tm = torch.stack([t2[c * rows + slot] for c in range(tape_f)], dim=-1)
            tm3_s = None
            if tm3 is not None:
                tm3_s = torch.stack([tm3[c * rows + slot] for c in range(3)], dim=-1)
            state, seed, alive = _bounce(rec, bg, state, hit, seed, alive, tm, tm3_s,
                                         rr_start, depth)
        fb = fb + state[3]
    return fb


def replay_cotangents(table, camv, idx2, g_fb, width: int, spp: int, max_depth: int, *,
                      row_offset: int = 0, sample_start: int = 0,
                      reference_quirk: bool = True, rr_start=None, t2=None,
                      want_texgrad: bool = False, chunk: int = DEFAULT_CHUNK):
    """The backward kernel's function, computed by autograd through
    `replay_frame`: returns (dtable `[TROWS, N]`, dcam `[15]`, fb `[N, 3]`,
    gtex `[3*spp*D, N]` or None). `idx2` `[spp*D, N]` int32, `g_fb`
    `[N, 3]`, `t2` the field-major texture tape `[F*spp*D, N]` or None."""
    n = idx2.shape[1]
    dev = table.device
    tape_f = 0 if t2 is None else t2.shape[0] // (spp * max_depth)
    dtable = torch.zeros_like(table)
    dcam = torch.zeros_like(camv)
    fb = torch.empty((n, 3), dtype=torch.float32, device=dev)
    rows = spp * max_depth
    gtex = torch.zeros((3 * rows, n), dtype=torch.float32, device=dev) if want_texgrad else None
    for c0 in range(0, n, chunk):
        c1 = min(n, c0 + chunk)
        lin = torch.arange(c0, c1, dtype=torch.int64, device=dev)
        with torch.enable_grad():
            tab = table.detach().requires_grad_()
            cv = camv.detach().requires_grad_()
            leaves = [tab, cv]
            tm3 = None
            if want_texgrad:
                tm3 = t2[:3 * rows, c0:c1].detach().clone().requires_grad_()
                leaves.append(tm3)
            part = replay_frame(
                tab, cv, idx2[:, c0:c1], width, lin, spp, max_depth, row_offset=row_offset,
                sample_start=sample_start, reference_quirk=reference_quirk, rr_start=rr_start,
                t2=None if t2 is None else t2[:, c0:c1], tape_f=tape_f, tm3=tm3)
            loss = torch.sum(part * g_fb[c0:c1])
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        if grads[0] is not None:
            dtable += grads[0]
        if grads[1] is not None:
            dcam += grads[1]
        if want_texgrad and grads[2] is not None:
            gtex[:, c0:c1] = grads[2]
        fb[c0:c1] = part.detach()
    return dtable, dcam, fb, gtex
