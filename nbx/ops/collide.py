"""Cell-binned collision resolution at scale: window layouts and one pair
kernel.

The dense masked resolver (nbx.collisions) carries [C, C] pair matrices
(interactive up to a capacity of a few thousand); the XLA binned resolver
(nbx.collisions_binned) gathers per pair. This module sorts bodies by cell
once (nbx.ops.p3m.cell_sort) and sweeps contacts WINDOW by window.

Physics per pair (reference /root/reference/index.html:293-390):
  overlap        d^2 < (rA + rB)^2                      (L311-313)
  approaching    relVel . n < 0                         (L327)
  impulse        j = -(1+e)(v.n)/(1/mA+1/mB), e = 0.2   (L328-329)
  friction       jt = -(relVel . t) * 0.5 / (1/mA+1/mB) (L364-369)
  Baumgarte      push (minDist-d) * 0.8, mass-weighted  (L350-352)
  heating        dT = (E/m) * 0.2, E = mu/2 (v.n)^2     (L332-336)

Layout (the band-PACKED window): cells are grouped into (i, j) columns
along k. A column's k range is cut into bands of `band_cells` cells; the
TARGET window of (column, band) holds the bodies of its b cells (at most
t_cap), and its SOURCE block is the 3x3 neighbour columns' guarded strips
of b + 2 cells (at most s_cap bodies per strip, 9 strips). cell_sort keeps
k minor within a column, so every window and strip is a contiguous run of
the sorted order: targets are one consecutive-run gather, and the strips
are built once per (column, band) and fused into each window's source
block as whole strips. Two layouts remain:

  * packed: every window of the grid at one (t_cap, s_cap);
  * bucketed: each OCCUPIED window in the first of a few (t_cap, s_cap,
    max_windows) buckets that covers it, so the bulk of windows does not
    pay the densest window's caps (bucketed_layout_for sizes them).

Windows exceeding a cap drop bodies (targets) or miss partners (sources);
both are counted into n_overflow, zero on caps from packed_caps_for or
bucketed_layout_for. OVERFLOW SYMMETRY: a target-cap drop removes the body
from the source strips too, so surviving impulses stay pairwise
equal-and-opposite. Source-cap drops are one-sided (a body's rank differs
between the up-to-3 band strips that contain it): treat nonzero n_overflow
from source caps as a re-tune signal, not a running mode.

The pair sweep of a window (the kernel): every target against every source
lane, five fused per-pair outputs reduced per target (Jacobi bounce and
Baumgarte deltas, heating, bounce count, and the deepest-overlap partner
record that feeds the contact timers), optionally plus the P3M erfc
short-range gravity over the same pairs. Both ordered copies of each pair
are processed, each side accumulating its own half of the impulse (the
Jacobi application, same divergence note as nbx.collisions). It runs as a
Pallas-Triton kernel (one program per target tile of a window, a loop over
the window's source lanes in chunks, the partner merge in registers) or as
the same sweep in plain jax.numpy under lax.map; nbx.backend picks.

Dead/padding bodies carry mass 0 and are masked by alive tests; clamped
duplicate neighbours at box faces point at an all-dead padding strip.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from nbx.backend import kernel_impl
from nbx.ops.p3m import cell_sort, take_rows

CORRECTION = 0.8  # Baumgarte factor (index.html:350)
HEAT_FRACTION = 0.2  # impact heating fraction (index.html:335)
DEPTH_SENTINEL = -1e30
_BIG = 3e38
# Abramowitz & Stegun 7.1.26 erfc coefficients (abs err <= 1.5e-7), for the
# fused P3M short-range gravity
_AS_P = 0.3275911
_AS_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
_N_FEAT = 9  # x y z vx vy vz m r gidx (feature rows are 16 wide)
# pair lanes per lax.map step of the XLA window sweep
_XLA_PAIR_LANES = 1 << 22
# the Triton kernel's [_BLOCK_T, _CHUNK] pair tile and warps per program:
# the fastest of a sweep on an H100 at 131k bodies (PERF.md)
_BLOCK_T, _CHUNK, _NUM_WARPS = 16, 32, 2


def _pair_sums(t, s, e, fric, grav):
    """Pair math of one target tile against one source tile.

    t: 9 target feature columns [..., T, 1]; s: 9 source feature rows
    [..., 1, S]; grav: None or (G, 1/a, 2/(a sqrt(pi)), eps^2). Returns
    (sums, dmax, jsel): 8 (11 with grav) per-target sums [..., T], the
    deepest overlap depth and the smallest source gidx at that depth.

    Exact algebraic cuts of the reference pair loop:
      * ONE reciprocal per pair: the impulse denominator 1/(1/mA + 1/mB)
        IS the reduced mass mu = mA mB/(mA + mB), so the masked mu carries
        impulse, friction and Baumgarte scale AND the impact energy
        E = mu/2 (v.n)^2 (L329, L333, L352, L369).
      * normals are never materialized: impulse = a2 * d - ft * rv with
        a2 = (j + ft vn) / dist folding the friction tangent (t_vec =
        rv - vn n, its normalization cancels, L364-369) and the 1/dist of
        n = d/dist into one coefficient.
    """
    xi, yi, zi, vxi, vyi, vzi, mi, ri, gi = t
    xj, yj, zj, vxj, vyj, vzj, mj, rj, gj = s
    dx = xj - xi  # i -> j
    dy = yj - yi
    dz = zj - zi
    r2 = dx * dx + dy * dy + dz * dz
    min_d = ri + rj
    alive2 = (mi > 0.0) & (mj > 0.0)
    distinct = jnp.abs(gi - gj) > 0.5
    overlap = alive2 & distinct & (r2 < min_d * min_d)

    inv_dist = jax.lax.rsqrt(jnp.where(r2 > 0.0, r2, 1.0))
    dist = r2 * inv_dist  # sqrt(r2), 0 at r2 == 0
    rvx = vxj - vxi
    rvy = vyj - vyi
    rvz = vzj - vzi
    vn = (rvx * dx + rvy * dy + rvz * dz) * inv_dist
    appr = overlap & (vn < 0.0)

    m_sum = mi + mj
    r_ms = 1.0 / jnp.where(m_sum > 0.0, m_sum, 1.0)
    mu_g = jnp.where(appr, mi * mj * r_ms, 0.0)  # masked reduced mass

    tvn = vn * mu_g  # masked mu * vn, shared by impulse and heating
    j_imp = -(1.0 + e) * tvn  # L328-329
    ft = fric * mu_g  # friction impulse = -ft * t_vec (L364-369)
    a2 = (j_imp + ft * vn) * inv_dist
    # Baumgarte push (minDist - d) mu 0.8 along n (L350-352)
    c2 = (min_d - dist) * inv_dist * (CORRECTION * mu_g)
    red = lambda x: jnp.sum(x, axis=-1)
    sums = [
        red(a2 * dx - ft * rvx),
        red(a2 * dy - ft * rvy),
        red(a2 * dz - ft * rvz),
        red(c2 * dx),
        red(c2 * dy),
        red(c2 * dz),
        red(0.5 * vn * tvn),  # impact heating E = mu/2 (v.n)^2 (L333-336)
        red(jnp.where(appr, 1.0, 0.0)),
    ]
    if grav is not None:
        # P3M erfc short-range gravity over the same pair lanes:
        # w = m_j (erfc(x)/s + c_a e^-x^2) / s^2, x = s/a, s^2 = r^2 + eps^2
        g_sc, inv_a, c_a, eps2 = grav
        s2 = r2 + eps2
        inv_s = jax.lax.rsqrt(jnp.where(s2 > 0.0, s2, 1.0))
        x = (s2 * inv_s) * inv_a
        ex2 = jnp.exp(-x * x)
        tt = 1.0 / (1.0 + _AS_P * x)
        poly = _AS_A[4]
        for a_k in (_AS_A[3], _AS_A[2], _AS_A[1], _AS_A[0]):
            poly = poly * tt + a_k
        erfc_x = poly * tt * ex2
        wg = jnp.where(
            alive2 & distinct & (r2 > 0.0),
            mj * (erfc_x * inv_s + c_a * ex2) * (inv_s * inv_s),
            0.0,
        )
        sums += [red(wg * dx), red(wg * dy), red(wg * dz)]
    # deepest-overlap partner, ties broken by the smallest source gidx, so
    # the pick does not depend on lane or chunk position
    depth = jnp.where(overlap, min_d - dist, DEPTH_SENTINEL)
    dmax = jnp.max(depth, axis=-1)
    cand = depth >= dmax[..., None]
    jsel = jnp.min(jnp.where(cand, gj + jnp.zeros_like(depth), _BIG), axis=-1)
    return sums, dmax, jsel


def _window_rows(mi, sums, dmax, jsel, grav):
    """Per-target output columns: delta (8), event record (2), and the
    short-range gravity (3, with grav). mi [..., T] target masses."""
    sc_i = jnp.where(mi > 0.0, 1.0 / jnp.where(mi > 0.0, mi, 1.0), 0.0)
    # target side of the pair impulse: vel_i -= (a2 d - ft rv) / m_i
    delta = [-sums[k] * sc_i for k in range(6)]
    delta += [sums[6] * sc_i * HEAT_FRACTION, sums[7]]
    has = dmax > 0.0
    evt = [jnp.where(has, dmax, DEPTH_SENTINEL), jnp.where(has, jsel, -1.0)]
    out = [delta, evt]
    if grav is not None:
        out.append([grav[0] * sums[k] for k in (8, 9, 10)])
    return out


def _grav_par(par):
    return None if par.shape[0] == 2 else tuple(par[k] for k in range(2, 6))


def _window_kernel(par_ref, tgt_ref, src_ref, *out_refs, t_rows: int,
                   s_rows: int, block_t: int, chunk: int):
    """Program (w, b): targets [b block_t, (b+1) block_t) of window w
    against all s_rows source lanes of window w, `chunk` lanes per loop
    step. tgt_ref [n_win t_rows, 16]; src_ref [n_win 16, s_rows];
    out_refs: delta [M, 8], evt [M, 2] (+ grav [M, 3])."""
    w = pl.program_id(0)
    r = pl.program_id(1) * block_t + jnp.arange(block_t)
    r_ok = r < t_rows
    rows = w * t_rows + r
    # masked target rows read mass 0: dead, every pair masked
    t_cols = [plt.load(tgt_ref.at[rows, f], mask=r_ok, other=0.0)
              for f in range(_N_FEAT)]
    t = [c[:, None] for c in t_cols]
    e, fric = par_ref[0], par_ref[1]
    grav = None if len(out_refs) == 2 else tuple(
        par_ref[k] for k in range(2, 6))

    def step(c, carry):
        acc, dmax, jsel = carry
        lanes = c * chunk + jnp.arange(chunk)
        l_ok = lanes < s_rows
        s = [plt.load(src_ref.at[w * 16 + f, lanes], mask=l_ok,
                      other=0.0)[None, :] for f in range(_N_FEAT)]
        sums, dm, js = _pair_sums(t, s, e, fric, grav)
        acc = tuple(a + x for a, x in zip(acc, sums))
        # cross-chunk merge: max depth, ties to the smallest gidx
        jsel = jnp.where(dm > dmax, js,
                         jnp.where(dm == dmax, jnp.minimum(js, jsel), jsel))
        return acc, jnp.maximum(dm, dmax), jsel

    zero = jnp.zeros((block_t,), jnp.float32)
    init = ((zero,) * (8 if grav is None else 11),
            jnp.full((block_t,), DEPTH_SENTINEL, jnp.float32),
            jnp.full((block_t,), _BIG, jnp.float32))
    acc, dmax, jsel = jax.lax.fori_loop(0, pl.cdiv(s_rows, chunk), step,
                                        init)
    for ref, cols in zip(out_refs,
                         _window_rows(t_cols[6], acc, dmax, jsel, grav)):
        for k, col in enumerate(cols):
            plt.store(ref.at[rows, k], col, mask=r_ok)


def _collide_windows_xla(par, tgt, src, n_win: int, t_rows: int,
                         s_rows: int):
    """The window sweep in plain jax.numpy, windows batched under lax.map."""
    e, fric, grav = par[0], par[1], _grav_par(par)
    tgt3 = tgt.reshape(n_win, t_rows, 16)
    src3 = src.reshape(n_win, 16, s_rows)

    def one(ts):
        tw, sw = ts
        t = [tw[:, f:f + 1] for f in range(_N_FEAT)]
        s = [sw[f:f + 1, :] for f in range(_N_FEAT)]
        sums, dmax, jsel = _pair_sums(t, s, e, fric, grav)
        return [jnp.stack(cols, -1)
                for cols in _window_rows(t[6][:, 0], sums, dmax, jsel, grav)]

    batch = max(1, min(n_win, _XLA_PAIR_LANES // max(t_rows * s_rows, 1)))
    outs = jax.lax.map(one, (tgt3, src3), batch_size=batch)
    return [o.reshape(n_win * t_rows, o.shape[-1]) for o in outs]


def collide_windows(par, tgt, src, n_win: int, t_rows: int, s_rows: int,
                    interpret: bool = False):
    """The pair sweep of n_win windows: returns [delta [M, 8], evt [M, 2]]
    (+ grav [M, 3] when par carries the short-range gravity parameters),
    M = n_win * t_rows, rows in target-slot order.

    par: [2] restitution, friction (or [6], see _collide_par);
    tgt [M, 16] target feature rows; src [n_win * 16, s_rows] each window's
    source block, feature-major."""
    if kernel_impl("collide", interpret) == "xla":
        return _collide_windows_xla(par, tgt, src, n_win, t_rows, s_rows)
    block_t, chunk = _BLOCK_T, _CHUNK
    if interpret:  # the interpreter pays per loop step: take big tiles
        block_t, chunk = min(128, pl.next_power_of_2(t_rows)), 128
    m = n_win * t_rows
    f32 = jnp.float32
    shapes = [jax.ShapeDtypeStruct((m, 8), f32),
              jax.ShapeDtypeStruct((m, 2), f32)]
    if par.shape[0] == 6:
        shapes.append(jax.ShapeDtypeStruct((m, 3), f32))
    kernel = functools.partial(_window_kernel, t_rows=t_rows, s_rows=s_rows,
                               block_t=block_t, chunk=chunk)
    return pl.pallas_call(
        kernel,
        grid=(n_win, pl.cdiv(t_rows, block_t)),
        out_shape=shapes,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=_NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="nbx_collide",
    )(par, tgt, src)


def _collide_par(restitution, friction, short_gravity=None):
    """Kernel parameter vector: [2] plain, [6] with fused short-range
    gravity (G, 1/a, 2/(a sqrt(pi)), eps^2 appended — all dynamic, so
    retuning G/a/eps never recompiles)."""
    f32 = jnp.float32
    base = [jnp.asarray(restitution, f32), jnp.asarray(friction, f32)]
    if short_gravity is None:
        return jnp.stack(base)
    G, a, eps = short_gravity
    a32 = jnp.asarray(a, f32)
    return jnp.stack(base + [
        jnp.asarray(G, f32), 1.0 / a32,
        2.0 / (a32 * jnp.sqrt(jnp.pi).astype(f32)),
        jnp.asarray(eps, f32) ** 2,
    ])


def _body_feats(pos, vel, mass, radius, box_size):
    """[N + 1, 16] feature matrix; row n = dead padding parked far away."""
    n = pos.shape[0]
    f32 = jnp.float32
    feats = jnp.zeros((n + 1, 16), f32)
    feats = feats.at[:n, 0:3].set(pos.astype(f32))
    feats = feats.at[:n, 3:6].set(vel.astype(f32))
    feats = feats.at[:n, 6].set(mass.astype(f32))
    feats = feats.at[:n, 7].set(radius.astype(f32))
    feats = feats.at[:n, 8].set(jnp.arange(n, dtype=f32))
    feats = feats.at[n, 0:3].set(2.0 * box_size)
    feats = feats.at[n, 8].set(-2.0)  # never matches a real gidx
    return feats


def _column_neighbors_rect(gx: int, gy: int):
    """9-neighbourhood column ids [gx*gy, 9] on an (x, y) column grid;
    invalid offsets -> gx*gy (the dead column). The (di, dj) enumeration
    order is shared by every layout (tie-break layout-invariance)."""
    return _column_neighbors_of(jnp.arange(gx * gy, dtype=jnp.int32), gx, gy)


def _column_neighbors(g: int):
    """9-neighbourhood column ids [g*g, 9]; invalid offsets -> g*g."""
    return _column_neighbors_rect(g, g)


def _column_neighbors_of(cc, gx: int, gy: int | None = None):
    """9-neighbourhood column ids [..., 9] for column ids cc (traced ok)
    on a gx x gy column grid (gy defaults to gx); invalid -> gx*gy."""
    gy = gx if gy is None else gy
    n_cols = gx * gy
    ci, cj = cc // gy, cc % gy
    neigh = []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            ni, nj = ci + di, cj + dj
            ok = (ni >= 0) & (ni < gx) & (nj >= 0) & (nj < gy)
            neigh.append(jnp.where(ok, ni * gy + nj, n_cols))
    return jnp.stack(neigh, axis=-1)


def _window_counts(pos, box_size: float, n_cells: int, band_cells: int):
    """Per-(column, band) occupancies of target windows and guarded source
    strips, as numpy arrays [n_cols, n_bands] (host-side measurement)."""
    import numpy as np

    g = n_cells
    b = band_cells
    n_bands = -(-g // b)
    _, starts, _ = cell_sort(jnp.asarray(pos), box_size, g)
    st = np.asarray(starts)
    cols = np.arange(g * g, dtype=np.int64)
    w = np.arange(n_bands, dtype=np.int64)
    cnt_t = (
        st[cols[:, None] * g + np.minimum(w[None, :] * b + b, g)]
        - st[cols[:, None] * g + w[None, :] * b]
    )
    cnt_s = (
        st[cols[:, None] * g + np.minimum(w[None, :] * b + b + 1, g)]
        - st[cols[:, None] * g + np.maximum(w[None, :] * b - 1, 0)]
    )
    return cnt_t, cnt_s


def _window_max_strip_runs(pos, box_size: float, n_cells: int,
                           band_cells: int, cnt_s=None):
    """Per-window (column x band) MAX guarded-strip run over the 9 neighbour
    columns, numpy [n_cols, n_bands] (host-side). This — not the own-column
    run — is what the per-strip source cap of the bucketed layout must
    cover. Pass cnt_s (from _window_counts) to skip a second census."""
    import numpy as np

    g = n_cells
    if cnt_s is None:
        _, cnt_s = _window_counts(pos, box_size, n_cells, band_cells)
    n_bands = cnt_s.shape[1]
    # pad with a zero-run virtual column for out-of-range neighbours
    cs = np.concatenate([cnt_s, np.zeros((1, n_bands), cnt_s.dtype)], axis=0)
    idx = np.asarray(_column_neighbors(g))
    return cs[idx].max(axis=1)


def bucket_flags_host(cnt_t, maxrun, caps):
    """First-covering-bucket window assignment, numpy bool arrays per
    bucket (host-side) — THE assignment rule; _assign_buckets implements
    the same rule on device, and every host-side budget sizing must go
    through here so budgets stay in sync with the caps."""
    occ = cnt_t > 0
    remaining = occ
    out = []
    for bi, (t, sc, _) in enumerate(caps):
        if bi == len(caps) - 1:
            fl = remaining
        else:
            fl = remaining & (cnt_t <= t) & (maxrun <= sc)
        remaining = remaining & ~fl
        out.append(fl)
    return out


def bucketed_layout_for(
    pos,
    box_size: float,
    n_cells: int,
    band_cells: int,
    split_quantile: float = 0.8,
    slack: float = 1.25,
    block_slack: float = 1.3,
    max_source_lanes: int = 8192,
    _stats=None,  # precomputed (cnt_t, maxrun) — skips the device census
) -> tuple[tuple[int, int, int], ...]:
    """Measure THIS frame's window occupancy and size a two-bucket layout
    for binned_collision_pass(buckets=...):
    ((t_cap1, s_cap1, max_windows1), (t_cap2, s_cap2, max_windows2)).

    Bucket 1 takes every occupied window whose target count and max
    neighbour-strip run fit caps sized at `split_quantile` of the occupied
    distribution; bucket 2 takes the tail at max-sized caps. Single-tier
    caps must track the densest window (an extreme-value tail that grows
    with the window count), so the bulk of windows would pay
    ~cap_tail/cap_median more pair lanes than their occupancy needs; two
    buckets bound that tax at the cost of one extra kernel launch.
    HOST-side: returns python ints (static jit args — call per scene or
    when n_overflow goes nonzero)."""
    import numpy as np

    if _stats is None:
        cnt_t, cnt_s = _window_counts(pos, box_size, n_cells, band_cells)
        maxrun = _window_max_strip_runs(pos, box_size, n_cells,
                                        band_cells, cnt_s=cnt_s)
    else:
        cnt_t, maxrun = _stats
    occ = cnt_t > 0
    if not occ.any():
        return ((8, 8, 8), (8, 8, 8))
    oc, orun = cnt_t[occ], maxrun[occ]

    def cap(v):
        return max(8, int(np.ceil(v * slack)))

    t1 = cap(np.quantile(oc, split_quantile))
    s1 = cap(np.quantile(orun, split_quantile))
    t2 = cap(oc.max())
    s2 = cap(orun.max())
    in1, in2 = bucket_flags_host(
        cnt_t, maxrun, ((t1, s1, 0), (t2, s2, 0))
    )
    if 9 * s2 > max_source_lanes:
        raise ValueError(
            f"bucketed tail caps ({t2}, {s2}) need {9 * s2} source lanes"
            f" per window (> {max_source_lanes}). Use a finer n_cells."
        )

    def budget(k):
        return max(8, -(-int(np.ceil(k * block_slack)) // 8) * 8)

    return (
        (t1, s1, budget(int(in1.sum()))),
        (t2, s2, budget(int(in2.sum()))),
    )


def packed_caps_for(
    pos,
    box_size: float,
    n_cells: int,
    band_cells: int,
    slack: float = 1.25,
    quantile: float = 1.0,
    max_source_lanes: int = 4096,
) -> tuple[int, int]:
    """Measure THIS frame's window occupancies and suggest
    packed_caps = (t_cap, s_cap) covering them with `slack` headroom for
    drift until the caller re-tunes. HOST-side (returns python ints —
    packed_caps is a static jit argument; call once per scene or when
    n_overflow goes nonzero).

    quantile < 1.0 caps at that occupancy quantile of the OCCUPIED windows
    instead of the max — bounded work at the price of counted overflow.

    Uniform caps only pay when occupancy is near-uniform. On a peaked scene
    (a thin debris annulus where a few per cent of windows hold every body)
    covering the dense windows multiplies the pair work; this raises when
    the suggestion exceeds max_source_lanes source lanes per window — use
    the bucketed layout (bucketed_layout_for) there.
    """
    import numpy as np

    cnt_t, cnt_s = _window_counts(pos, box_size, n_cells, band_cells)

    def pick(cnt):
        occ = cnt[cnt > 0]
        if occ.size == 0:
            return 8
        v = occ.max() if quantile >= 1.0 else np.quantile(occ, quantile)
        return max(8, int(np.ceil(v * slack)))

    t_cap, s_cap = pick(cnt_t), pick(cnt_s)
    if 9 * s_cap > max_source_lanes:
        occ_frac = float((cnt_t > 0).mean())
        raise ValueError(
            f"packed caps ({t_cap}, {s_cap}) need {9 * s_cap} source lanes"
            f" (> {max_source_lanes}): occupancy is too peaked for uniform"
            f" window caps ({occ_frac:.1%} of windows occupied). Use the"
            " bucketed layout (bucketed_layout_for), a lower quantile=, or"
            " a finer n_cells."
        )
    return t_cap, s_cap


def _block_geom(t_cap: int, s_cap: int):
    """(t_rows, s_capw, s_rows): target rows per window, lanes per source
    strip, source lanes per window (9 strips)."""
    s_capw = max(s_cap, 8)
    return max(t_cap, 8), s_capw, 9 * s_capw


def _check_construction(construction: str):
    if construction not in ("auto", "grid", "slice"):
        raise ValueError(
            f"construction must be 'auto', 'grid' or 'slice', got"
            f" {construction!r}"
        )


def _gather_targets(feats_sorted, ts, cnt, t_rows: int):
    """Target rows [prod(ts.shape) * t_rows, 16]: the consecutive sorted run
    starting at ts of length min(cnt, t_rows), dead-padded."""
    n = feats_sorted.shape[0] - 1
    ar = jnp.arange(t_rows, dtype=jnp.int32)
    valid = ar < jnp.minimum(cnt, t_rows)[..., None]
    take = jnp.minimum(ts[..., None] + ar, n)
    return feats_sorted[jnp.where(valid, take, n)].reshape(-1, 16)


def _strips_table(feats_sorted, t_ok, ss, runs, s_capw: int,
                  construction: str = "grid"):
    """Guarded source strips [n_c + 1, n_bands, 16, s_capw] (the last one
    all dead) from strip starts ss and run lengths runs [n_c, n_bands].
    Bodies with t_ok False (target-dropped) are left out.

    construction: "grid" gathers rows with the mask folded into the index;
    "slice" takes each strip as one contiguous [16, s_capw] slice off a
    masked, transposed copy of the sorted features; "auto" takes "slice"
    for tables of >= 6e5 strip lanes (where it was the faster build)."""
    n = feats_sorted.shape[0] - 1
    dead = feats_sorted[n]
    n_bands = ss.shape[1]
    valid = (jnp.arange(s_capw, dtype=jnp.int32)
             < jnp.minimum(runs, s_capw)[..., None])
    if construction == "auto":
        construction = "slice" if ss.size * s_capw >= 600_000 else "grid"
    if construction == "slice":
        op = jnp.concatenate(
            [jnp.where(t_ok[:n, None], feats_sorted[:n], dead),
             jnp.broadcast_to(dead[None], (s_capw + 1, 16))], 0)
        op_t = op.T  # [16, n + s_capw + 1]
        strips = jax.vmap(
            lambda s: jax.lax.dynamic_slice(op_t, (0, s), (16, s_capw))
        )(ss.reshape(-1)).reshape(ss.shape + (16, s_capw))
        strips = jnp.where(valid[:, :, None, :], strips, dead[:, None])
    else:
        take = jnp.minimum(ss[..., None] + jnp.arange(s_capw), n)
        strips = feats_sorted[
            jnp.where(valid & t_ok[take], take, n)
        ].swapaxes(-1, -2)
    dead_strip = jnp.broadcast_to(dead[:, None], (1, n_bands, 16, s_capw))
    return jnp.concatenate([strips, dead_strip], axis=0)


def _fuse_all_windows(strips, neigh):
    """Source blocks [n_win * 16, 9 s_capw] of every (column, band) window,
    column-major: strips [n_c + 1, n_bands, 16, s_capw], neigh [cols, 9]
    strip-table rows of each window column's 9 neighbours."""
    fused = strips[neigh]  # [cols, 9, n_bands, 16, s_capw]
    return fused.transpose(0, 2, 3, 1, 4).reshape(-1, 9 * fused.shape[-1])


def _gather_neighborhoods(feats_sorted, t_ok, ss, se, valid_w, s_capw):
    """Source blocks [B * 16, 9 s_capw] by direct row gathers of each
    selected window's 9 neighbour runs [ss, se) ([B, 9] each) — the build
    for buckets that serve few windows."""
    n = feats_sorted.shape[0] - 1
    ar = jnp.arange(s_capw, dtype=jnp.int32)
    valid = (ar < jnp.minimum(se - ss, s_capw)[..., None]) \
        & valid_w[:, None, None]
    take = jnp.minimum(ss[..., None] + ar, n)
    rows = feats_sorted[jnp.where(valid & t_ok[take], take, n)]
    return rows.transpose(0, 3, 1, 2).reshape(-1, 9 * s_capw)


def _assign_buckets(cnt_t, maxrun, buckets):
    """First-covering-bucket assignment of occupied windows on device (the
    rule of bucket_flags_host). A window past a bucket's window budget
    SPILLS to the next bucket; only the last bucket's budget drops
    windows. Returns per-bucket (flags, selected, rank) over flat window
    ids."""
    out = []
    remaining = cnt_t > 0
    for bi, (t_cap, s_cap, bmax) in enumerate(buckets):
        if bi == len(buckets) - 1:
            fl = remaining
        else:
            fl = remaining & (cnt_t <= t_cap) & (maxrun <= s_cap)
        flf = fl.reshape(-1)
        wrank = jnp.cumsum(flf.astype(jnp.int32)) - 1
        sel = flf & (wrank < bmax)
        remaining = remaining & ~sel.reshape(cnt_t.shape)
        out.append((flf, sel, wrank))
    return out


@functools.partial(
    jax.jit,
    static_argnames=("n_cells", "band_cells", "packed_caps", "buckets",
                     "interpret", "construction"),
)
def binned_collision_pass(
    pos,  # [N, 3] — binning domain [0, box)^3 (out-of-box clipped to faces)
    vel,  # [N, 3]
    mass,  # [N] (0 = dead/padding)
    radius,  # [N]
    box_size: float,
    n_cells: int,
    restitution=0.2,
    friction=0.5,
    band_cells: int | None = None,
    packed_caps: tuple[int, int] | None = None,
    buckets: tuple[tuple[int, int, int], ...] | None = None,
    interpret: bool = False,
    construction: str = "auto",
):
    """One collision sweep over the 27-cell neighbourhoods.

    Returns (dvel [N,3], dpos [N,3], dtemp [N], best, n_bounces, n_overflow,
    cell_too_small) where `best` is the per-body deepest-overlap partner
    record: dict(j [N] i32 (-1 = none), vn, q, energy, m_j [N] f32,
    approaching [N] bool). Deltas are Jacobi accumulations to ADD to the
    caller's state (same contract as nbx.collisions_binned).

    band_cells=B sets the window height in cells (default n_cells: whole
    columns). Exactly one layout: packed_caps=(t_cap, s_cap) (every window
    of the grid; size with packed_caps_for) or buckets=((t1, s1, m1),
    (t2, s2, m2), ...) (occupied windows only, each in the first bucket
    whose caps cover it, at most m_k windows per bucket; size with
    bucketed_layout_for). n_overflow counts cap violations (target drops +
    missed source slots + windows past the last bucket's budget); it is 0
    whenever the caps cover every window. Bodies that overlap from more
    than one cell apart in k are missed — the regime cell_too_small flags.

    construction ("auto" | "grid" | "slice") picks how the bucketed
    layout's bulk strips table is built (_strips_table)."""
    _check_construction(construction)
    if band_cells is None:
        band_cells = n_cells
    if not 1 <= band_cells <= n_cells:
        raise ValueError(
            f"band_cells must be in [1, {n_cells}], got {band_cells}")
    if (packed_caps is None) == (buckets is None):
        raise ValueError("give exactly one of packed_caps and buckets")
    n = pos.shape[0]
    cell_too_small = 2.0 * jnp.max(radius) > box_size / n_cells
    feats = _body_feats(pos, vel, mass, radius, box_size)
    par = _collide_par(restitution, friction)

    if buckets is not None:
        out_d, out_e, n_overflow = _packed_bucketed_blocks(
            feats, par, pos, box_size, n_cells, band_cells, buckets,
            interpret, construction,
        )
        return _epilogue_finish(
            out_d, out_e, pos, vel, mass, n, n_overflow, cell_too_small
        )

    g = n_cells
    b = band_cells
    n_cols = g * g
    n_bands = -(-g // b)
    t_rows, s_capw, s_rows = _block_geom(*packed_caps)
    n_win = n_cols * n_bands
    i32 = jnp.int32

    order, starts, cid_sorted = cell_sort(pos, box_size, g)
    feats_sorted = jnp.concatenate([feats[order], feats[n:]], axis=0)
    cols = jnp.arange(n_cols, dtype=i32)
    w_r = jnp.arange(n_bands, dtype=i32)
    # target window: cells [w b, min((w+1) b, g))
    ts_tab = starts[cols[:, None] * g + w_r[None, :] * b]
    cnt_t = starts[cols[:, None] * g + jnp.minimum(w_r * b + b, g)] - ts_tab
    # guarded source strip: cells [max(w b - 1, 0), min(w b + b + 1, g))
    ss_tab = starts[cols[:, None] * g + jnp.maximum(w_r * b - 1, 0)]
    runs = starts[cols[:, None] * g + jnp.minimum(w_r * b + b + 1, g)] \
        - ss_tab
    n_overflow = (jnp.sum(jnp.maximum(cnt_t - t_rows, 0))
                  + jnp.sum(jnp.maximum(runs - s_capw, 0)))

    tgt = _gather_targets(feats_sorted, ts_tab, cnt_t, t_rows)
    # body -> its target-block slot (inverse of the window layout)
    p_r = jnp.arange(n, dtype=i32)
    col_s = cid_sorted // g
    w_own = (cid_sorted - col_s * g) // b
    rank_t = p_r - ts_tab[col_s, w_own]
    slot_sorted = jnp.where(
        rank_t < t_rows, (col_s * n_bands + w_own) * t_rows + rank_t,
        n_win * t_rows,
    )
    body_slot = slot_sorted[_invert_order(order)]

    # target-cap-dropped bodies leave the source strips too (symmetry)
    t_ok = jnp.concatenate([rank_t < t_rows, jnp.zeros((1,), bool)])
    strips = _strips_table(feats_sorted, t_ok, ss_tab, runs, s_capw)
    src = _fuse_all_windows(strips, _column_neighbors(g))
    delta, evt = collide_windows(par, tgt, src, n_win, t_rows, s_rows,
                                 interpret)
    return _collide_epilogue(
        delta, evt, body_slot, pos, vel, mass, n, n_overflow, cell_too_small
    )


def _packed_bucketed_blocks(
    feats,
    par,
    pos,
    box_size: float,
    n_cells: int,
    band_cells: int,
    buckets: tuple[tuple[int, int, int], ...],
    interpret: bool,
    construction: str = "auto",
):
    """OCCUPANCY-BUCKETED packed layout: each occupied window runs in the
    first bucket whose (t_cap, s_cap) covers its target count and max
    neighbour-strip run and whose window budget still has room (windows
    past a budget spill to the next bucket; the last bucket takes every
    remaining window and is the only place window drops happen, counted).
    Each bucket is one window sweep at its own caps.

    Construction: bucket 0 (the bulk), when its budget covers a quarter of
    the grid or more, builds the whole-grid strips table ONCE at its cap
    and fuses each selected window's 9 strips from it; other buckets (few
    windows) gather their neighbourhoods directly. The symmetric-drop mask
    (a body dropped from its target role vanishes from ALL buckets' source
    strips) is global across buckets.

    Returns (out_d [n, 8], out_e [n, 2], n_overflow) in BODY order — each
    body's target slot lives in exactly one bucket, so one gather through a
    combined slot map over the concatenated outputs collects them.
    """
    n = pos.shape[0]
    g = n_cells
    b = band_cells
    n_cols = g * g
    g3 = n_cols * g
    n_bands = -(-g // b)
    i32 = jnp.int32
    f32 = jnp.float32

    order, starts, cid_sorted = cell_sort(pos, box_size, g)
    feats_sorted = jnp.concatenate([feats[order], feats[n:]], axis=0)
    neigh = _column_neighbors(g)  # [n_cols, 9]; n_cols = invalid

    cols = jnp.arange(n_cols, dtype=i32)
    w_r = jnp.arange(n_bands, dtype=i32)
    ts_tab = starts[cols[:, None] * g + w_r[None, :] * b]
    cnt_t = starts[cols[:, None] * g + jnp.minimum(w_r * b + b, g)] - ts_tab
    lo = jnp.maximum(w_r * b - 1, 0)  # [n_bands] guarded strip cells
    hi = jnp.minimum(w_r * b + b + 1, g)
    okn = (neigh < n_cols)[:, None, :]
    ss9 = starts[jnp.where(okn, neigh[:, None, :] * g + lo[None, :, None],
                           g3)]  # [n_cols, n_bands, 9]
    se9 = starts[jnp.where(okn, neigh[:, None, :] * g + hi[None, :, None],
                           g3)]
    run9 = se9 - ss9
    assigned = _assign_buckets(cnt_t, jnp.max(run9, axis=2), buckets)

    # ---- global symmetric-drop mask over sorted positions -----------------
    p_r = jnp.arange(n, dtype=i32)
    col_s = cid_sorted // g
    w_own = (cid_sorted - col_s * g) // b
    f_own = col_s * n_bands + w_own
    rank_t = p_r - ts_tab[col_s, w_own]
    ok_sorted = jnp.zeros((n,), bool)
    for (_, sel, _), (t_cap, s_cap, _) in zip(assigned, buckets):
        t_rows = _block_geom(t_cap, s_cap)[0]
        ok_sorted = ok_sorted | (sel[f_own] & (rank_t < t_rows))
    t_ok = jnp.concatenate([ok_sorted, jnp.zeros((1,), bool)])

    deltas, evts = [], []
    m_total = sum(bm * _block_geom(t, s)[0] for t, s, bm in buckets)
    slot_all = jnp.full((n,), m_total, i32)
    slot_base = 0
    n_overflow = jnp.int32(0)
    cnt_flat = cnt_t.reshape(-1)
    for bi, ((t_cap, s_cap, bmax), (flf, sel, wrank)) in enumerate(
        zip(buckets, assigned)
    ):
        t_rows, s_capw, s_rows = _block_geom(t_cap, s_cap)
        if bi == len(buckets) - 1:  # only the last bucket drops windows
            n_overflow += jnp.sum(jnp.where(flf & ~sel, cnt_flat, 0))
        wsel, wvalid = take_rows(sel, bmax)
        col_sel = wsel // n_bands
        w_sel = wsel - col_sel * n_bands
        cnt_sel = jnp.where(wvalid, cnt_t[col_sel, w_sel], 0)
        n_overflow += jnp.sum(jnp.maximum(cnt_sel - t_rows, 0))
        run_sel = jnp.where(wvalid[:, None], run9[col_sel, w_sel], 0)
        n_overflow += jnp.sum(jnp.maximum(run_sel - s_capw, 0))
        tgt = _gather_targets(feats_sorted, ts_tab[col_sel, w_sel], cnt_sel,
                              t_rows)

        # The whole-grid strips table costs n_cols * n_bands * s_capw rows
        # regardless of how many windows the bucket serves: build it only
        # when the budget covers a substantial part of the grid.
        if bi == 0 and 4 * bmax >= n_cols * n_bands:
            ss_own = starts[cols[:, None] * g + lo[None, :]]
            runs = starts[cols[:, None] * g + hi[None, :]] - ss_own
            strips = _strips_table(feats_sorted, t_ok, ss_own, runs, s_capw,
                                   construction)
            fused = strips[neigh[col_sel], w_sel[:, None]]  # [B, 9, 16, s]
            src = fused.transpose(0, 2, 1, 3).reshape(-1, s_rows)
        else:
            src = _gather_neighborhoods(
                feats_sorted, t_ok, ss9[col_sel, w_sel], se9[col_sel, w_sel],
                wvalid, s_capw,
            )
        delta, evt = collide_windows(par, tgt, src, bmax, t_rows, s_rows,
                                     interpret)
        deltas.append(delta)
        evts.append(evt)
        slot_all = jnp.where(
            sel[f_own] & (rank_t < t_rows),
            slot_base + wrank[f_own] * t_rows + rank_t,
            slot_all,
        )
        slot_base += bmax * t_rows

    out_d, out_e = epilogue_rows(jnp.concatenate(deltas, 0),
                                 jnp.concatenate(evts, 0),
                                 slot_all[_invert_order(order)])
    return out_d, out_e, n_overflow


def _invert_order(order):
    """Body id -> sorted position (inverse permutation of cell_sort)."""
    return jnp.argsort(order).astype(jnp.int32)


def _slot_rows(x, body_slot, fill=0.0):
    """Rows of x [M, k] at each body's slot; slots >= M read `fill`."""
    m = x.shape[0]
    xp = jnp.concatenate([x, jnp.full((1, x.shape[1]), fill, x.dtype)], 0)
    return xp[jnp.clip(body_slot, 0, m)]


def epilogue_rows(delta, evt, body_slot):
    """Per-body (delta row [n, 8], event row [n, 2]) by slot gather.
    Bodies with no slot (body_slot >= rows) read the zero / sentinel
    padding row — under a sharded slab split, masking these to zero and
    psum-ing over chips reconstructs the whole-grid rows exactly (each body
    has a slot on exactly one chip)."""
    return (_slot_rows(delta, body_slot),
            _slot_rows(evt, body_slot, DEPTH_SENTINEL))


def _collide_epilogue(
    delta, evt, body_slot, pos, vel, mass, n, n_overflow, cell_too_small
):
    """Map kernel outputs back to body order (two n-row gathers through
    each body's target slot, computed from the cell sort) and rebuild the
    per-body deepest-partner record."""
    out_d, out_e = epilogue_rows(delta, evt, body_slot)
    return _epilogue_finish(
        out_d, out_e, pos, vel, mass, n, n_overflow, cell_too_small
    )


def _epilogue_finish(
    out_d, out_e, pos, vel, mass, n, n_overflow, cell_too_small
):
    """Final epilogue step shared by every layout: split the per-body
    delta rows and rebuild the deepest-partner record. The kernel only
    reports (depth, j); vn/Q/E/m_j/approaching follow O(N) from the
    PRE-pass state by the kernel's formulas (fp association may differ in
    the last ulp)."""
    f32 = jnp.float32
    dvel = out_d[:n, 0:3]
    dpos = out_d[:n, 3:6]
    dtemp = out_d[:n, 6]
    n_bounces = (jnp.sum(out_d[:n, 7]) / 2.0).astype(jnp.int32)

    has = out_e[:n, 0] > 0.0
    j_idx = jnp.where(has, out_e[:n, 1].astype(jnp.int32), -1)
    jc = jnp.clip(j_idx, 0, n - 1)
    d = pos[jc] - pos
    r2b = jnp.sum(d * d, axis=-1)
    invb = jax.lax.rsqrt(jnp.where(r2b > 0.0, r2b, 1.0))
    vnb = jnp.sum((vel[jc] - vel) * d, axis=-1) * invb
    m_j = mass[jc]
    m_sum = mass + m_j
    r_msb = 1.0 / jnp.where(m_sum > 0.0, m_sum, 1.0)
    e_b = 0.5 * (mass * m_j * r_msb) * vnb * vnb  # impact energy (L333)
    best = dict(
        j=j_idx,
        vn=jnp.where(has, vnb, 0.0).astype(f32),
        q=jnp.where(has, e_b * r_msb, 0.0).astype(f32),  # L338
        energy=jnp.where(has, e_b, 0.0).astype(f32),
        m_j=jnp.where(has, m_j, 0.0).astype(f32),
        approaching=has & (vnb < 0.0),
    )
    return dvel, dpos, dtemp, best, n_bounces, n_overflow, cell_too_small


def packed_collision_blocks_slab(
    pos,
    vel,
    mass,
    radius,
    box_size: float,
    n_cells: int,
    band_cells: int,
    packed_caps: tuple[int, int],
    restitution,
    friction,
    col_lo,  # first (i, j) column of this SLAB — TRACED (axis_index)
    n_slab_cols: int,  # columns in the slab (static)
    interpret: bool = False,
):
    """Packed layout + window sweep for the column slab [col_lo, col_lo +
    n_slab_cols) — the per-chip building block of the SHARDED collision
    pass (nbx.parallel.shard.make_sharded_binned_collision_pass). Source
    strips are built for the slab's +-(g+1)-column superset (clamped;
    out-of-grid ids map to empty windows), so slab block contents equal
    the same blocks of a whole-grid build.

    Returns (delta [B*T, 8], evt [B*T, 2], body_slot [N] (>= B*T for
    bodies with no slot in THIS slab), n_overflow over slab windows).
    """
    n = pos.shape[0]
    g = n_cells
    b = band_cells
    n_cols = g * g
    g3 = n_cols * g
    n_bands = -(-g // b)
    t_rows, s_capw, s_rows = _block_geom(*packed_caps)
    n_win = n_slab_cols * n_bands
    i32 = jnp.int32
    col_lo = jnp.asarray(col_lo, i32)

    feats = _body_feats(pos, vel, mass, radius, box_size)
    par = _collide_par(restitution, friction)
    order, starts, cid_sorted = cell_sort(pos, box_size, g)
    feats_sorted = jnp.concatenate([feats[order], feats[n:]], axis=0)

    # ---- window tables (slab columns x bands) ----------------------------
    cols = col_lo + jnp.arange(n_slab_cols, dtype=i32)
    w_r = jnp.arange(n_bands, dtype=i32)
    ts_tab = starts[cols[:, None] * g + w_r[None, :] * b]
    cnt_t = starts[cols[:, None] * g + jnp.minimum(w_r * b + b, g)] - ts_tab
    n_t_over = jnp.sum(jnp.maximum(cnt_t - t_rows, 0))
    lo_cell = jnp.maximum(w_r * b - 1, 0)
    hi_cell = jnp.minimum(w_r * b + b + 1, g)

    # ---- source-window tables over the slab's column SUPERSET ------------
    n_super = n_slab_cols + 2 * (g + 1)
    sup_lo = col_lo - (g + 1)
    sup_cols = sup_lo + jnp.arange(n_super, dtype=i32)
    sup_ok = (sup_cols >= 0) & (sup_cols < n_cols)
    sc = jnp.where(sup_ok, sup_cols, 0)
    ss_tab = starts[
        jnp.where(sup_ok[:, None], sc[:, None] * g + lo_cell[None, :], g3)
    ]
    runs = starts[
        jnp.where(sup_ok[:, None], sc[:, None] * g + hi_cell[None, :], g3)
    ] - ss_tab
    # overflow counted over the SLAB's own columns (superset rows
    # [g + 1, g + 1 + n_slab)) so per-chip psums add to the global count
    slab_rows = jax.lax.dynamic_slice_in_dim(runs, g + 1, n_slab_cols, 0)
    n_overflow = n_t_over + jnp.sum(jnp.maximum(slab_rows - s_capw, 0))

    tgt = _gather_targets(feats_sorted, ts_tab, cnt_t, t_rows)
    # body -> target-block slot; non-slab bodies get the sentinel
    p_r = jnp.arange(n, dtype=i32)
    col_s = cid_sorted // g
    w_own = (cid_sorted - col_s * g) // b
    in_slab = (col_s >= col_lo) & (col_s < col_lo + n_slab_cols)
    col_rel = jnp.clip(col_s - col_lo, 0, n_slab_cols - 1)
    rank_t = p_r - ts_tab[col_rel, w_own]
    slot_sorted = jnp.where(
        in_slab & (rank_t < t_rows),
        (col_rel * n_bands + w_own) * t_rows + rank_t,
        n_win * t_rows,
    )
    body_slot = slot_sorted[_invert_order(order)]

    # target-cap-dropped bodies leave the source role by their GLOBAL
    # window rank (a body can be dropped in another chip's slab yet sourced
    # here) — the same mask as the whole-grid packed build
    rank_g = p_r - starts[col_s * g + w_own * b]
    t_ok = jnp.concatenate([rank_g < t_rows, jnp.zeros((1,), bool)])
    strips = _strips_table(feats_sorted, t_ok, ss_tab, runs, s_capw)
    neigh_g = _column_neighbors_of(cols, g)  # [n_slab, 9]; n_cols invalid
    src = _fuse_all_windows(
        strips, jnp.where(neigh_g < n_cols, neigh_g - sup_lo, n_super))
    delta, evt = collide_windows(par, tgt, src, n_win, t_rows, s_rows,
                                 interpret)
    return delta, evt, body_slot, n_overflow


def cell_sort_slabgrid(pos, alive, box_size: float, n_cells: int,
                       x0_cell, gx: int, y0_cell=0, gy: int | None = None):
    """cell_sort over a LOCAL slab grid [gx, gy, g] whose x origin is the
    global cell layer x0_cell (TRACED — per-chip axis_index arithmetic):
    local lx = clip-to-box(global cx) - x0_cell, y/z as in cell_sort.
    With gy (default: the full g), the y axis is likewise a local window
    at traced origin y0_cell — the 2D (x, y) slab decomposition. Rows
    with lx/ly outside the local grid or alive=False map to the overflow
    cell gx*gy*g — parked at the END of the sort, never targeted or
    sourced. (Dead slots are parked deliberately, unlike the whole-grid
    sort where they occupy real cells: the halo-exchange step reuses
    slots freely and corpses must not eat window caps.)

    Returns (order [N] i32, starts [gx*gy*g + 1] i32, cid_sorted [N] i32).
    """
    g = n_cells
    if gy is None:
        gy = g
    h = box_size / g
    ijk = jnp.clip((pos / h).astype(jnp.int32), 0, g - 1)
    lx = ijk[:, 0] - jnp.asarray(x0_cell, jnp.int32)
    ly = ijk[:, 1] - jnp.asarray(y0_cell, jnp.int32)
    n_cells_loc = gx * gy * g
    cid = jnp.where(
        alive & (lx >= 0) & (lx < gx) & (ly >= 0) & (ly < gy),
        (lx * gy + ly) * g + ijk[:, 2],
        n_cells_loc,
    )
    order = jnp.argsort(cid).astype(jnp.int32)
    cid_sorted = cid[order]
    starts = jnp.searchsorted(
        cid_sorted, jnp.arange(n_cells_loc + 1)
    ).astype(jnp.int32)
    return order, starts, cid_sorted


class _LocalGrid:
    """Window tables of a LOCAL slab grid (see packed_collision_blocks_local):
    the per-body sort, owned target windows, and source strips over all
    local columns."""

    def __init__(self, pos, vel, mass, radius, box_size, g, b, x0_cell,
                 slab_x, y0_cell, slab_y):
        n = pos.shape[0]
        i32 = jnp.int32
        two_d = slab_y is not None
        w_x, w_y = slab_x, (slab_y if two_d else g)
        gx, gy = w_x + 2, (w_y + 2 if two_d else g)
        self.n_bands = n_bands = -(-g // b)
        self.n_cols_loc = n_cols_loc = gx * gy
        self.n_cols_own = n_cols_own = w_x * w_y
        self.feats = _body_feats(pos, vel, mass, radius, box_size)
        self.order, starts, cid_sorted = cell_sort_slabgrid(
            pos, mass > 0.0, box_size, g, x0_cell, gx,
            y0_cell if two_d else 0, gy,
        )
        self.starts = starts
        self.feats_sorted = jnp.concatenate(
            [self.feats[self.order], self.feats[n:]], axis=0)

        # owned columns. 1D: x layers [1, w_x + 1), all y — ids
        # [gy, gy + w_x*gy) contiguous. 2D: x AND y layers [1, w + 1).
        if two_d:
            ox = 1 + jnp.arange(w_x, dtype=i32)
            oy = 1 + jnp.arange(w_y, dtype=i32)
            self.cols_own = (ox[:, None] * gy + oy[None, :]).reshape(-1)
        else:
            self.cols_own = gy + jnp.arange(n_cols_own, dtype=i32)
        w_r = jnp.arange(n_bands, dtype=i32)
        own = self.cols_own[:, None] * g
        self.ts_tab = starts[own + w_r[None, :] * b]
        self.cnt_t = starts[own + jnp.minimum(w_r * b + b, g)] - self.ts_tab
        self.lo_cell = jnp.maximum(w_r * b - 1, 0)
        self.hi_cell = jnp.minimum(w_r * b + b + 1, g)
        # source strips over ALL local columns
        cols_all = jnp.arange(n_cols_loc, dtype=i32)
        self.ss_tab = starts[cols_all[:, None] * g + self.lo_cell[None, :]]
        self.runs = starts[cols_all[:, None] * g + self.hi_cell[None, :]] \
            - self.ss_tab
        self.neigh_own = _column_neighbors_rect(gx, gy)[self.cols_own]

        # per-body window mapping (sorted order)
        self.col_s = col_s = cid_sorted // g  # n_cols_loc for parked rows
        self.w_own = jnp.minimum(cid_sorted - col_s * g, g - 1) // b
        if two_d:
            cxl = col_s // gy
            cyl = col_s - cxl * gy
            self.owned = ((cxl >= 1) & (cxl < w_x + 1)
                          & (cyl >= 1) & (cyl < w_y + 1))
            self.col_rel = jnp.clip((cxl - 1) * w_y + (cyl - 1), 0,
                                    n_cols_own - 1)
        else:
            self.owned = (col_s >= gy) & (col_s < gy + n_cols_own)
            self.col_rel = jnp.clip(col_s - gy, 0, n_cols_own - 1)
        p_r = jnp.arange(n, dtype=i32)
        self.rank_t = p_r - self.ts_tab[self.col_rel, self.w_own]
        # rank in the window this row sits in (halo rows: their halo window)
        self.rank_w = p_r - starts[
            jnp.minimum(col_s * g + self.w_own * b, n_cols_loc * g)]


def packed_collision_blocks_local(
    pos,
    vel,
    mass,
    radius,
    box_size: float,
    n_cells: int,
    band_cells: int,
    packed_caps: tuple[int, int],
    restitution,
    friction,
    x0_cell,  # global x cell layer of LOCAL layer 0 (= slab_lo - 1) — TRACED
    slab_x: int,  # owned x layers (static); local grid is [slab_x + 2, g, g]
    interpret: bool = False,
    y0_cell=0,  # with slab_y: global y layer of LOCAL y 0 — TRACED
    slab_y: int | None = None,  # owned y layers (static): 2D slab grid
    #   [slab_x + 2, slab_y + 2, g]; None = the y axis stays whole (1D)
    short_gravity=None,  # (G, a, eps) dynamic scalars: ALSO accumulate the
    #   P3M erfc short-range gravity over the same pair blocks; the return
    #   gains a grav element
):
    """Packed layout + window sweep over a LOCAL slab grid — the per-chip
    building block of the HALO-EXCHANGE sharded granular step
    (nbx.parallel.spatial). It takes only the chip's OWN body slots plus
    its halo rows ([nl + 2H] arrays, any order) and bins them into a
    [slab_x + 2, g, g] local grid: global x cell layer x0_cell maps to
    local layer 0 (the left halo layer), owned layers are [1, slab_x + 1),
    layer slab_x + 1 is the right halo. With slab_y, the y axis is ALSO a
    local window ([slab_x + 2, slab_y + 2, g] grid at traced origin
    (x0_cell, y0_cell)) — the 2D slab decomposition; the caller's halo
    rows must then cover both boundary x-layers and boundary y-layers
    INCLUDING the diagonal corners. TARGET windows cover only the owned
    layers' columns; source strips cover ALL local columns, so owned
    targets see their +-1 neighbours through the halo rows.

    Pair-set parity with the whole-grid packed build (zero overflow) is
    gated by tests/test_spatial.py. Under TARGET-cap overflow the drop set
    of a boundary window is decided by the LOCAL sort order, which can
    differ from the neighbouring chip's order for its halo copy; overflow
    is counted and zero-overflow caps give layout-invariant results.
    Partner tie-breaks on bitwise-equal depths use LOCAL ids and can
    likewise differ at the halo boundary (the mutual gate then fails:
    bounce-only, no event).

    Returns (delta [B*T, 8], evt [B*T, 2], body_slot [nl + 2H] (sentinel
    for halo/overflow/dead rows), n_overflow over OWNED windows); with
    short_gravity set, (delta, evt, grav [B*T, 3], body_slot, n_overflow).
    """
    lg = _LocalGrid(pos, vel, mass, radius, box_size, n_cells, band_cells,
                    x0_cell, slab_x, y0_cell, slab_y)
    n_bands = lg.n_bands
    t_rows, s_capw, s_rows = _block_geom(*packed_caps)
    n_win = lg.n_cols_own * n_bands
    par = _collide_par(restitution, friction, short_gravity)

    # source overflow counted over OWNED columns only: each boundary
    # window is owned by exactly one chip, so per-chip psums add up to a
    # whole-grid count without double-counting halo copies
    n_overflow = (jnp.sum(jnp.maximum(lg.cnt_t - t_rows, 0))
                  + jnp.sum(jnp.maximum(lg.runs[lg.cols_own] - s_capw, 0)))
    tgt = _gather_targets(lg.feats_sorted, lg.ts_tab, lg.cnt_t, t_rows)
    slot_sorted = jnp.where(
        lg.owned & (lg.rank_t < t_rows),
        (lg.col_rel * n_bands + lg.w_own) * t_rows + lg.rank_t,
        n_win * t_rows,
    )
    body_slot = slot_sorted[_invert_order(lg.order)]

    # target-cap-dropped bodies leave the source role by their LOCAL window
    # rank (halo rows use their halo-window rank)
    t_ok = jnp.concatenate([
        (lg.rank_w < t_rows) & (lg.col_s < lg.n_cols_loc),
        jnp.zeros((1,), bool),
    ])
    strips = _strips_table(lg.feats_sorted, t_ok, lg.ss_tab, lg.runs, s_capw)
    src = _fuse_all_windows(strips, lg.neigh_own)
    outs = collide_windows(par, tgt, src, n_win, t_rows, s_rows, interpret)
    return (*outs, body_slot, n_overflow)


def bucketed_collision_blocks_local(
    pos,
    vel,
    mass,
    radius,
    box_size: float,
    n_cells: int,
    band_cells: int,
    buckets: tuple[tuple[int, int, int], ...],
    restitution,
    friction,
    x0_cell,
    slab_x: int,
    interpret: bool = False,
    y0_cell=0,
    slab_y: int | None = None,
    short_gravity=None,  # (G, a, eps): fuse the P3M erfc short-range sum;
    #   the return gains an out_g element
    construction: str = "auto",  # bucket-0 strips build (_strips_table)
):
    """Occupancy-BUCKETED variant of packed_collision_blocks_local: the
    local slab grid's OWNED windows run in the first bucket whose caps
    cover them (see _packed_bucketed_blocks for the bucket rules and
    bucketed_layout_for for sizing).

    Returns (out_d [n, 8], out_e [n, 2], n_overflow-over-owned-windows) in
    LOCAL row order (halo rows read the zero/sentinel padding); with
    short_gravity, (out_d, out_e, out_g [n, 3], n_overflow). Divergence
    note: a HALO row's symmetric-drop rank check uses the LAST bucket's
    t_rows (its owner's bucket choice depends on occupancy this chip cannot
    see); under zero overflow the masks agree exactly.
    """
    _check_construction(construction)
    lg = _LocalGrid(pos, vel, mass, radius, box_size, n_cells, band_cells,
                    x0_cell, slab_x, y0_cell, slab_y)
    g = n_cells
    n = pos.shape[0]
    n_bands = lg.n_bands
    n_cols_loc = lg.n_cols_loc
    g3 = n_cols_loc * g
    i32 = jnp.int32
    par = _collide_par(restitution, friction, short_gravity)

    runs_pad = jnp.concatenate([lg.runs, jnp.zeros((1, n_bands), i32)], 0)
    run9 = runs_pad[
        jnp.where(lg.neigh_own < n_cols_loc, lg.neigh_own, n_cols_loc)
    ]  # [own, 9, n_bands]
    assigned = _assign_buckets(lg.cnt_t, jnp.max(run9, axis=1), buckets)
    f_own = lg.col_rel * n_bands + lg.w_own

    # symmetric-drop mask: owned rows by their bucket; halo rows by the
    # LAST bucket's rows (see docstring)
    ok_sorted = jnp.zeros((n,), bool)
    for (_, sel, _), (t_cap, s_cap, _) in zip(assigned, buckets):
        t_rows = _block_geom(t_cap, s_cap)[0]
        ok_sorted = ok_sorted | (lg.owned & sel[f_own] & (lg.rank_t < t_rows))
    t_last = _block_geom(*buckets[-1][:2])[0]
    ok_sorted = ok_sorted | (
        ~lg.owned & (lg.col_s < n_cols_loc) & (lg.rank_w < t_last))
    t_ok = jnp.concatenate([ok_sorted, jnp.zeros((1,), bool)])
    inv = _invert_order(lg.order)

    out = None
    n_overflow = jnp.int32(0)
    cnt_flat = lg.cnt_t.reshape(-1)
    for bi, ((t_cap, s_cap, bmax), (flf, sel, wrank)) in enumerate(
        zip(buckets, assigned)
    ):
        t_rows, s_capw, s_rows = _block_geom(t_cap, s_cap)
        if bi == len(buckets) - 1:  # only the last bucket drops windows
            n_overflow += jnp.sum(jnp.where(flf & ~sel, cnt_flat, 0))
        wsel, wvalid = take_rows(sel, bmax)
        ocr = wsel // n_bands  # own-column rank
        w_sel = wsel - ocr * n_bands
        cnt_sel = jnp.where(wvalid, lg.cnt_t[ocr, w_sel], 0)
        n_overflow += jnp.sum(jnp.maximum(cnt_sel - t_rows, 0))
        # source overflow counted on each window's OWN strip (neighbour 4 =
        # the (0, 0) offset): every window is owned by exactly one chip, so
        # per-chip psums add up without double counting shared strips
        own_run = jnp.where(wvalid, run9[ocr, 4, w_sel], 0)
        n_overflow += jnp.sum(jnp.maximum(own_run - s_capw, 0))
        tgt = _gather_targets(lg.feats_sorted, lg.ts_tab[ocr, w_sel],
                              cnt_sel, t_rows)

        neigh_sel = lg.neigh_own[ocr]  # [bmax, 9] local column ids
        if bi == 0 and 4 * bmax >= n_cols_loc * n_bands:
            strips = _strips_table(lg.feats_sorted, t_ok, lg.ss_tab, lg.runs,
                                   s_capw, construction)
            loc = jnp.where(neigh_sel < n_cols_loc, neigh_sel, n_cols_loc)
            fused = strips[loc, w_sel[:, None]]  # [bmax, 9, 16, s_capw]
            src = fused.transpose(0, 2, 1, 3).reshape(-1, s_rows)
        else:
            okn = neigh_sel < n_cols_loc
            ss = lg.starts[jnp.where(
                okn, neigh_sel * g + lg.lo_cell[w_sel][:, None], g3)]
            se = lg.starts[jnp.where(
                okn, neigh_sel * g + lg.hi_cell[w_sel][:, None], g3)]
            src = _gather_neighborhoods(lg.feats_sorted, t_ok, ss, se,
                                        wvalid, s_capw)
        outs = collide_windows(par, tgt, src, bmax, t_rows, s_rows,
                               interpret)
        slot_sorted = jnp.where(
            lg.owned & sel[f_own] & (lg.rank_t < t_rows),
            wrank[f_own] * t_rows + lg.rank_t,
            bmax * t_rows,
        )
        body_slot = slot_sorted[inv]
        rows = [_slot_rows(o, body_slot, DEPTH_SENTINEL if k == 1 else 0.0)
                for k, o in enumerate(outs)]
        if out is None:
            out = rows
        else:  # each body has its slot in one bucket: sum, pick the event
            out = [out[0] + rows[0],
                   jnp.where((rows[1][:, 0] > out[1][:, 0])[:, None],
                             rows[1], out[1]),
                   *(a + r for a, r in zip(out[2:], rows[2:]))]
    return (*out, n_overflow)
