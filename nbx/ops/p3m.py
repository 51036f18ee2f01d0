"""P3M (particle-particle / particle-mesh) gravity — accurate AND O(N).

Raw PM (nbx.ops.pm) softens forces at the grid scale (~5% median error on a
cluster). P3M restores small-scale accuracy with the classic Ewald-style
split of the interaction:

    1/r = erf(r / a) / r   +   erfc(r / a) / r
          \\__ long-range __/    \\__ short-range, ~0 beyond r_c = 3a __/

  * LONG RANGE on the mesh: identical to the PM pipeline but with the
    smoothed free-space Green's function  -erf(r/a)/r  (finite at r = 0),
    so the mesh never sees structure below the smoothing scale `a` — mesh
    aliasing errors vanish.
  * SHORT RANGE exactly, pairwise, within the cutoff: bodies are binned
    into cells of size r_c (one argsort per evaluation), and each cell
    interacts with its 27-cell neighborhood through a dense masked pair
    block — regular, vectorizable work (~N * 27 K pair evaluations for K
    bodies/cell), chunked through lax.map to bound memory.

The short-range force magnitude (d/dr of the short potential):

    F_s(r) / (G m) = erfc(r/a) / r^2 + 2 / (a sqrt(pi)) * exp(-(r/a)^2) / r

with Plummer softening applied by evaluating at s = sqrt(r^2 + eps^2).

Accuracy: ~3e-3 median vs direct sum on quasi-uniform distributions (gated
in tests/test_p3m.py) with mesh spacing h <= a/1.7 (i.e. g >= ~5-6 n_cells);
cost O(N + G^3 log G).

Applicability: cell occupancy is handled ADAPTIVELY. Bodies overflowing
max_per_cell are routed through an exact residual short-range pass
(_residual_short_acc: each overflowing body against its 27-neighborhood's
table bodies with the reaction scattered back, plus dense
residual-residual), so clustered cores keep full accuracy up to
max_residual overflowing bodies per evaluation; only beyond that cap do
corrections drop, and the returned count gates it (no-silent-caps).
p3m_tune_for sizes a tune for a given scene. For collisional cluster
cores where most bodies overflow, the exact paths (direct sum, sharded
direct) are still the right tool; P3M targets the large-N regime where
direct O(N^2) stops paying.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.scipy.special import erfc

from nbx.ops.pm import _cic_window, cic_deposit, cic_gather


def cell_sort(pos, box_size: float, n_cells: int):
    """Sort bodies by cell id, k (the z cell coordinate) MINOR within each
    (i, j) column — so any k-window of cells within a column is one
    CONTIGUOUS run of the sorted order (the property the band-packed
    collision layout builds on, nbx.ops.collide).

    Returns (order [N] i32, starts [g^3 + 1] i32, cid_sorted [N] i32):
    bodies of cell c are order[starts[c] : starts[c + 1]], and bodies of
    cells [c0, c1) of one column are order[starts[c0] : starts[c1]].
    """
    n = pos.shape[0]
    g = n_cells
    h = box_size / g
    ijk = jnp.clip((pos / h).astype(jnp.int32), 0, g - 1)
    cid = (ijk[:, 0] * g + ijk[:, 1]) * g + ijk[:, 2]  # [N]
    order = jnp.argsort(cid).astype(jnp.int32)
    cid_sorted = cid[order]
    starts = jnp.searchsorted(
        cid_sorted, jnp.arange(g * g * g + 1)
    ).astype(jnp.int32)
    return order, starts, cid_sorted


def cell_bin_full(pos, box_size: float, n_cells: int, max_per_cell: int):
    """Bin bodies into an [n_cells^3] grid of cubic cells.

    Returns (table [C, K] body indices padded with N, counts [C],
    n_overflow, dropped [N] bool). Bodies beyond max_per_cell in a cell are
    dropped from the table; `dropped` marks them per body so callers can
    route them through a residual correction (p3m_acceleration does) — the
    overflow count is always surfaced (no-silent-caps rule).
    """
    n = pos.shape[0]
    g = n_cells
    order, starts, cid_sorted = cell_sort(pos, box_size, g)
    # rank of each body within its cell
    rank = jnp.arange(n, dtype=jnp.int32) - starts[cid_sorted]
    ok = rank < max_per_cell
    counts = starts[1:] - starts[:-1]
    # table rows are consecutive runs of the sorted order — build by
    # GATHER (table[c, j] = order[starts[c] + j] for j < min(count, K)),
    # not the equivalent [C, K]-scatter (scatters measured 4-16x slower
    # than sort/gather forms — nbx.bench.microops)
    ar = jnp.arange(max_per_cell, dtype=jnp.int32)
    valid = ar[None, :] < jnp.minimum(counts, max_per_cell)[:, None]
    order_p = jnp.concatenate([order, jnp.full((1,), n, jnp.int32)])
    table = jnp.where(
        valid, order_p[jnp.minimum(starts[:-1][:, None] + ar, n)], n
    )
    n_overflow = n - jnp.sum(ok.astype(jnp.int32))
    # gather through the inverse permutation, not an N-scatter (scatters
    # measured 4-16x slower than sort/gather forms — nbx.bench.microops)
    dropped = ~ok[jnp.argsort(order)]
    return table, counts, n_overflow, dropped


def cell_bin(pos, box_size: float, n_cells: int, max_per_cell: int):
    """cell_bin_full without the per-body dropped mask (compat wrapper)."""
    table, counts, n_overflow, _ = cell_bin_full(
        pos, box_size, n_cells, max_per_cell
    )
    return table, counts, n_overflow


def take_rows(mask: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """First-k set rows of a [N] bool mask in index order -> (idx [k],
    valid [k]). Binary searches over the mask's cumsum — no sort/top_k over
    the body axis and no rank scatter."""
    n = mask.shape[0]
    csum = jnp.cumsum(mask.astype(jnp.int32))
    want = jnp.arange(1, k + 1, dtype=jnp.int32)
    idx = jnp.searchsorted(csum, want, side="left").astype(jnp.int32)
    valid = want <= csum[-1]
    return jnp.minimum(idx, n - 1), valid


def p3m_tune_for(
    pos,
    box_size: float,
    g_candidates: tuple[int, ...] = (64, 96, 128),
    cells_candidates: tuple[int, ...] = (8, 10, 12, 16, 20, 24, 28, 32, 40),
    k_max: int = 768,
    residual_budget: int = 49152,
    k_quantile: float = 0.98,
    pair_budget: float = 8.0e10,
) -> dict:
    """Host-side P3M configuration census: pick (g, n_cells, max_per_cell,
    max_residual) for THIS scene's occupancy.

    A tune sized for a quasi-uniform field does not transfer to arbitrary
    geometry: a thin disk concentrates N bodies into a 2D sheet of cells,
    so per-cell occupancy scales like sigma * cell^2 and overflows by 100x.
    This helper measures the actual per-cell histogram (numpy, one pass per
    candidate) and picks the config that maximizes mesh accuracy
    a/h = g/(3 n_cells) subject to:

      * K = occupancy quantile `k_quantile` (rounded to 8, or to 128 above
        128, <= k_max) — the kept-table premise holds for the bulk;
      * residuals (bodies past K in their cell) <= residual_budget — the
        exact residual pass absorbs them (its rr block is O(M^2));
      * main-pass pair lanes N * 27 * K <= pair_budget.

    Returns dict(g, n_cells, max_per_cell, max_residual, a_over_h,
    n_residual, pair_lanes) — kwargs-compatible with p3m_acceleration via
    the first four keys. Raises ValueError if no candidate fits (scene
    denser than the budgets allow). Call per scene, or re-call when
    n_uncorrected goes nonzero."""
    import numpy as np

    p = np.asarray(pos)
    best = None
    best_score = None
    for n_cells in cells_candidates:
        h = box_size / n_cells
        ijk = np.clip((p / h).astype(np.int64), 0, n_cells - 1)
        cid = (ijk[:, 0] * n_cells + ijk[:, 1]) * n_cells + ijk[:, 2]
        cnt = np.bincount(cid, minlength=n_cells**3)
        occ = cnt[cnt > 0]
        k = int(np.quantile(occ, k_quantile)) if occ.size else 8
        k = min(max(8, -(-k // 128) * 128 if k > 128 else -(-k // 8) * 8),
                k_max)
        n_res = int(np.maximum(cnt - k, 0).sum())
        if n_res > residual_budget:
            continue
        lanes = p.shape[0] * 27 * k
        if lanes > pair_budget:
            continue
        for g in g_candidates:
            if g < 3 * n_cells:
                continue
            a_over_h = g / (3.0 * n_cells)
            # accuracy saturates at a/h ~ 1.78 (h <= a/1.7, module
            # docstring); past it only cost grows — score the clamped
            # ratio, tie-break on a cost proxy (pair lanes + the padded
            # FFT volume, in lane-equivalents)
            cost = lanes + 15.0 * (2 * g) ** 3 * np.log2(2 * g)
            score = (min(a_over_h, 1.78), -cost)
            if best_score is not None and score <= best_score:
                continue
            best_score = score
            best = dict(
                g=g, n_cells=n_cells, max_per_cell=k,
                max_residual=max(256, -(-int(n_res * 1.5) // 256) * 256),
                a_over_h=a_over_h, n_residual=n_res, pair_lanes=lanes,
            )
    if best is None:
        raise ValueError(
            "no P3M tune fits the budgets: the scene is denser than "
            f"residual_budget={residual_budget} allows at every candidate "
            "n_cells — raise the budgets or use direct/PM gravity"
        )
    return best


def _short_force_mag(s, a, G):
    """|F|/m_j at softened distance s (see module docstring)."""
    x = s / a
    return G * (
        erfc(x) / (s * s)
        + (2.0 / (a * jnp.sqrt(jnp.pi))) * jnp.exp(-x * x) / s
    )


@functools.partial(
    jax.jit, static_argnames=("n_cells", "max_per_cell", "chunk")
)
def short_range_acc(
    pos, mass, G, a, box_size: float, n_cells: int,
    max_per_cell: int = 16, eps=0.0, chunk: int | None = None,
    table=None, n_overflow=None,
):
    """Pairwise short-range correction within the 27-cell neighborhood.

    Cell size box/n_cells must be >= the cutoff (~3a) for the neighborhood
    to capture every interacting pair. Returns ([N, 3] acc, n_overflow).
    Pass `table`/`n_overflow` to reuse a precomputed cell_bin
    (p3m_acceleration does, to avoid a second argsort over N).

    chunk (cells per lax.map step) defaults to a K-adaptive size keeping
    the per-step pair block at ~2^28 lanes. XLA may materialize the
    [chunk, K, K, 3] blocks of all 27 offsets at once (the CPU backend
    does), so the step is sized by memory: one such f32 buffer is ~3 GB,
    a small share of an 80 GB card and of a CPU host, where a fixed
    chunk=512 at K=768 would ask for 130 GB.
    """
    n = pos.shape[0]
    g = n_cells
    if chunk is None:
        chunk = max(8, min(512, (1 << 28) // max(27 * max_per_cell ** 2, 1)))
    if table is None:
        table, _, n_overflow = cell_bin(pos, box_size, g, max_per_cell)
    c_total = g * g * g
    # padded body arrays: index n = a zero-mass body parked at a far corner
    pos_p = jnp.concatenate([pos, jnp.full((1, 3), 2.0 * box_size)], 0)
    mass_p = jnp.concatenate([mass, jnp.zeros((1,))], 0)

    # 27-neighborhood cell ids (clamped at the box faces; duplicates from
    # clamping are harmless for the force but would double-count pairs —
    # mask them out)
    cc = jnp.arange(c_total, dtype=jnp.int32)
    ci = cc // (g * g)
    cj = (cc // g) % g
    ck = cc % g
    neigh = []
    dup_mask = []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                ni = jnp.clip(ci + di, 0, g - 1)
                nj = jnp.clip(cj + dj, 0, g - 1)
                nk = jnp.clip(ck + dk, 0, g - 1)
                valid = (
                    (ni == ci + di) & (nj == cj + dj) & (nk == ck + dk)
                )
                neigh.append((ni * g + nj) * g + nk)
                dup_mask.append(valid)
    neigh = jnp.stack(neigh, 1)  # [C, 27]
    dup_mask = jnp.stack(dup_mask, 1)  # [C, 27]

    k = max_per_cell
    a32 = jnp.asarray(a, jnp.float32)
    eps2 = jnp.asarray(eps, jnp.float32) ** 2

    def cell_chunk(c0):
        # One [chunk, K, K] pair block per neighbor offset (27 of them):
        # memory stays O(chunk K^2) so K can grow for clustered scenes.
        cs_raw = c0 + jnp.arange(chunk)
        in_range = cs_raw < c_total
        cs = jnp.minimum(cs_raw, c_total - 1)
        tgt_idx = table[cs]  # [chunk, K]
        # rows past c_total would re-process the last cell and double-count
        # its forces in the scatter-add — point them at the padding body
        tgt_idx = jnp.where(in_range[:, None], tgt_idx, n)
        tgt_pos = pos_p[tgt_idx]  # [chunk, K, 3]
        acc_c = jnp.zeros((chunk, k, 3), jnp.float32)
        for o in range(27):
            src_idx = table[neigh[cs, o]]  # [chunk, K]
            src_idx = jnp.where(dup_mask[cs, o][:, None], src_idx, n)
            src_pos = pos_p[src_idx]  # [chunk, K, 3]
            src_mass = mass_p[src_idx]  # [chunk, K]
            d = src_pos[:, None, :, :] - tgt_pos[:, :, None, :]  # [c,K,K,3]
            r2 = jnp.sum(d * d, -1)
            s2 = r2 + eps2
            s = jnp.sqrt(jnp.where(s2 > 0, s2, 1.0))
            w = jnp.where(
                (r2 > 0) & (src_mass[:, None, :] > 0),
                _short_force_mag(s, a32, G) * src_mass[:, None, :] / s,
                0.0,
            )
            acc_c = acc_c + jnp.einsum("ckj,ckjd->ckd", w, d)
        return acc_c, tgt_idx

    n_chunks = (c_total + chunk - 1) // chunk
    accs, idxs = jax.lax.map(
        cell_chunk, jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    )
    acc = jnp.zeros((n + 1, 3), jnp.float32)
    acc = acc.at[idxs.reshape(-1)].add(accs.reshape(-1, 3), mode="drop")
    return acc[:n], n_overflow


def _residual_short_acc(
    pos, mass, G, a, eps, box_size: float, n_cells: int, table,
    res_idx, res_valid, chunk: int = 256, include_rr: bool = True,
):
    """Short-range correction for bodies dropped from the cell table.

    A dropped body a misses its short-range pairs in BOTH directions: a
    never appears as target or source. This restores them exactly:

      * a vs its 27-neighborhood's TABLE bodies ([M, 27K] blocks), with the
        equal-and-opposite reaction scatter-added onto the table bodies;
      * a vs the other dropped bodies (dense [M, M], both ordered copies
        present so no separate reaction is needed) — skipped when
        include_rr=False (the two-level path solves residual-residual on a
        refined submesh instead, _residual_rr_twolevel).

    Pairs beyond the neighborhood are ~0 by the erfc cutoff — the same
    approximation the main pass makes. Cost O(M_actual (27K + M_cap)):
    chunks past the live overflow count are skipped at runtime via
    lax.cond, so an over-provisioned max_residual costs (almost) nothing
    when the scene doesn't overflow. Returns an [N, 3] delta.
    """
    n = pos.shape[0]
    g = n_cells
    k = table.shape[1]
    m = res_idx.shape[0]
    h = box_size / g
    a32 = jnp.asarray(a, jnp.float32)
    eps2 = jnp.asarray(eps, jnp.float32) ** 2

    pos_p = jnp.concatenate([pos, jnp.full((1, 3), 2.0 * box_size)], 0)
    mass_p = jnp.concatenate([mass, jnp.zeros((1,))], 0)
    ridx_p = jnp.where(res_valid, res_idx, n)
    pr = pos_p[ridx_p]  # [M, 3]
    mr = mass_p[ridx_p]  # [M]

    # 27-neighborhood table rows per residual body
    ijk = jnp.clip((pr / h).astype(jnp.int32), 0, g - 1)
    neighs = []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                ni = ijk[:, 0] + di
                nj = ijk[:, 1] + dj
                nk = ijk[:, 2] + dk
                ok = (
                    (ni >= 0) & (ni < g) & (nj >= 0) & (nj < g)
                    & (nk >= 0) & (nk < g)
                )
                cidn = (jnp.clip(ni, 0, g - 1) * g
                        + jnp.clip(nj, 0, g - 1)) * g + jnp.clip(nk, 0, g - 1)
                neighs.append(jnp.where(ok & res_valid, cidn, g * g * g))
    neigh = jnp.stack(neighs, 1)  # [M, 27]
    table_p = jnp.concatenate(
        [table, jnp.full((1, k), n, jnp.int32)], 0
    )  # padded row for invalid neighbors

    def w_of(d):  # [.., 3] -> short-force weight F(s)/s per pair
        r2 = jnp.sum(d * d, -1)
        s2 = r2 + eps2
        s = jnp.sqrt(jnp.where(s2 > 0, s2, 1.0))
        return jnp.where(r2 > 0, _short_force_mag(s, a32, G) / s, 0.0), r2

    def res_chunk(m0):
        rows = m0 + jnp.arange(chunk)
        rows = jnp.minimum(rows, m - 1)
        live = (m0 + jnp.arange(chunk)) < m
        p_c = pr[rows]  # [c, 3]
        m_c = jnp.where(live, mr[rows], 0.0)
        src = table_p[neigh[rows]].reshape(chunk, 27 * k)  # [c, 27K]
        sp = pos_p[src]
        sm = mass_p[src]
        d = sp - p_c[:, None, :]  # [c, 27K, 3]
        w, _ = w_of(d)
        w = w * jnp.where(live[:, None], 1.0, 0.0)
        # residual body's acceleration from table sources
        acc_r = jnp.einsum("ck,ckd->cd", w * sm, d)
        # reaction on the table sources: -w * m_res * d, folded to
        # per-(neighbor CELL, table slot) rows — see the scatter note below
        react = (-(w * m_c[:, None])[..., None] * d).reshape(chunk, 27, k, 3)
        if include_rr:
            # residual-residual (both directions present across rows)
            drr = pr[None, :, :] - p_c[:, None, :]  # [c, M, 3]
            wrr, _ = w_of(drr)
            wrr = wrr * jnp.where(live[:, None], 1.0, 0.0)
            acc_r = acc_r + jnp.einsum("ck,ckd->cd", wrr * mr[None, :], drr)
        return acc_r, react, neigh[rows]

    n_chunks = (m + chunk - 1) // chunk
    n_live = jnp.sum(res_valid.astype(jnp.int32))
    g3 = g * g * g

    # REACTION SCATTER AT CELL GRANULARITY: the original implementation
    # scattered every (residual, table-slot) pair row straight into the
    # [N, 3] body array — M * 27K three-float rows (85M at the 1M+30k
    # bench scene), each a conflicting row update. Fold instead:
    # each (residual row, neighbor) contributes ONE [K, 3] block to its
    # neighbor CELL -> M * 27 wide rows (27K/3x fewer, K*3-float lanes)
    # into a [g^3 + 1, K, 3] grid, accumulated as a lax.scan carry so the
    # per-pair reaction tensor is never materialized whole. The grid then
    # reaches bodies by a pure GATHER: a table body's slot is a FUNCTION
    # of the cell sort (slot = cid * K + rank), so no second scatter.
    def guarded(acc_cells, m0):
        # skip chunks entirely past the live overflow count: runtime cost
        # scales with the ACTUAL overflow, not the static max_residual cap
        zero = (
            jnp.zeros((chunk, 3), jnp.float32),
            jnp.zeros((chunk, 27, k, 3), jnp.float32),
            jnp.full((chunk, 27), g3, jnp.int32),
        )
        acc_r, react, cells = jax.lax.cond(
            m0 < n_live, res_chunk, lambda _: zero, m0
        )
        acc_cells = acc_cells.at[cells.reshape(-1)].add(
            react.reshape(-1, k, 3)
        )
        return acc_cells, acc_r

    acc_cells, acc_r = jax.lax.scan(
        guarded,
        jnp.zeros((g3 + 1, k, 3), jnp.float32),
        jnp.arange(n_chunks, dtype=jnp.int32) * chunk,
    )
    order, starts, cid_sorted = cell_sort(pos, box_size, g)
    p_i = jnp.arange(n, dtype=jnp.int32)
    rank_s = p_i - starts[cid_sorted]
    slot_s = jnp.where(rank_s < k, cid_sorted * k + rank_s, g3 * k)
    inv = jnp.argsort(order).astype(jnp.int32)  # no N-scatter (microops)
    flat = jnp.concatenate(
        [acc_cells[:g3].reshape(g3 * k, 3), jnp.zeros((1, 3), jnp.float32)],
        axis=0,
    )  # row g3*k = zero (cap-dropped bodies; the g3 junk cell is cut)
    acc = jnp.zeros((n + 1, 3), jnp.float32)
    acc = acc.at[:n].add(flat[jnp.minimum(slot_s[inv], g3 * k)])
    # rows beyond m were clamped to m-1: drop their duplicate residual accs
    rows_ok = (
        jnp.arange(n_chunks * chunk) < m
    )[:, None]
    acc = acc.at[
        jnp.where(rows_ok[:, 0], ridx_p[jnp.minimum(
            jnp.arange(n_chunks * chunk), m - 1)], n)
    ].add(jnp.where(rows_ok, acc_r.reshape(-1, 3), 0.0), mode="drop")
    return acc[:n]


def _residual_rr_twolevel(
    pos, mass, G, eps, a0, res_idx, res_valid,
    sub_g: int = 64, sub_cells: int = 16, sub_k: int = 64,
    out_cap: int = 1024,
):
    """Residual-residual short-range term on a REFINED submesh — the
    two-level P3M that replaces the dense [M, M] block of
    _residual_short_acc for large overflows (ROADMAP: clustered cores).

    The level-0 short kernel splits once more at the submesh scale a1:

        erfc(r/a0)/r = [erf(r/a1) - erf(r/a0)]/r   (band -> submesh FFT)
                     + erfc(r/a1)/r                (short1 -> fine binned PP)

    The submesh is a cube centered dynamically on the residual bodies and
    sized to the QUANTILE box [0.005, 0.995] of their per-axis positions:
    grid RESOLUTION is static, the physical size is a traced value (XLA
    shapes never depend on the data), so the same executable serves a
    tight core or a scattered overflow — for scattered residuals a1 >= a0
    and the band just carries a negative correction (the split identity
    holds for any a1 > 0). Quantile sizing is what makes the pass ROBUST:
    max-extent sizing let a handful of scattered field-cell overflows
    inflate the submesh to the whole box, squeezing the real core into
    ~2 submesh cells (measured on the 1M+30k bench scene: 26k fine-binning
    drops, core error 0.38). Residuals OUTSIDE the quantile box get the
    EXACT dense rr term instead, against all residual rows (an
    [out_cap, M] block; reactions land on in-submesh rows only, so
    out-out pairs are counted once per ordered copy exactly like the
    dense path) — out-rows past out_cap are counted uncorrected. Real
    in-submesh bodies stay >= 1 cell from the submesh boundary (size
    margin), so the boundary face cells are free to park the dead padding
    and out-of-box rows without evicting live table slots.

    Restricted to the residual SET, exactly like the dense block it
    replaces. Cost O(sub_g^3 log + M 27 K1 + out_cap M) vs O(M^2).
    Returns ([N, 3] delta, n_sub_uncorrected).
    """
    from jax.scipy.special import erf

    if sub_cells < 4:
        # the size-factor margin sub_cells/(sub_cells - 2.5) assumes
        # >= ~1.25 cells of boundary padding; <= 2 flips its sign entirely
        raise ValueError(f"sub_cells must be >= 4, got {sub_cells}")
    if sub_g < 3 * sub_cells:
        # a1 = l1/sub_cells/3 must be resolved by the submesh (h1 = l1/sub_g
        # <= a1), exactly the level-0 rule g >= 3*n_cells. Measured when
        # violated ((sub_cells=32, sub_g=64) -> h1 = 1.5*a1): core median
        # error 2.6e-2 vs 4.5e-3 at a resolved tune on the same scene.
        raise ValueError(
            f"sub_g={sub_g} under-resolves a1: need sub_g >= 3*sub_cells "
            f"(= {3 * sub_cells}) so the submesh band term is accurate"
        )
    n = pos.shape[0]
    m = res_idx.shape[0]
    i32 = jnp.int32
    pos_p = jnp.concatenate([pos, jnp.zeros((1, 3))], 0)
    mass_p = jnp.concatenate([mass, jnp.zeros((1,))], 0)
    ridx_p = jnp.where(res_valid, res_idx, n)
    pr = pos_p[ridx_p]  # [M, 3]
    mr = jnp.where(res_valid, mass_p[ridx_p], 0.0)

    # robust extent: per-axis median +- 6x the interquartile half-width of
    # the live rows (dead rows sort last behind +BIG). The median/IQR pair
    # tracks the BULK of the residual mass: a Gaussian core is covered to
    # ~4 sigma (6 x 0.674 sigma), while satellite clumps or stragglers —
    # whatever their count — sit outside and take the exact fallback. A
    # coverage quantile cannot do this: a 12%-of-residuals clump drags a
    # [0.5%, 99.5%] box across the whole domain (measured: core error
    # 0.18 on a core+clumps scene).
    n_live = jnp.sum(res_valid.astype(i32))
    live_f = jnp.maximum(n_live.astype(jnp.float32), 1.0)
    qs = jnp.sort(jnp.where(res_valid[:, None], pr, 3.0e38), axis=0)
    at = lambda f: jnp.take(
        qs, jnp.clip((f * live_f).astype(i32), 0, m - 1), axis=0
    )
    q25, q50, q75 = at(0.25), at(0.50), at(0.75)
    c = q50
    half = jnp.maximum(jnp.max(3.0 * (q75 - q25)), 1e-3)
    l1 = 2.0 * half * (sub_cells / (sub_cells - 2.5))
    # in-submesh test against the real capacity (>= 1 cell of margin)
    half_in = 0.5 * l1 - l1 / sub_cells
    in_sub = res_valid & jnp.all(jnp.abs(pr - c) <= half_in, axis=1)
    mr_sub = jnp.where(in_sub, mr, 0.0)
    q = pr - c + 0.5 * l1
    # park invalid AND out-of-box rows spread over the (real-free) far
    # x face
    t = jnp.arange(q.shape[0], dtype=jnp.float32)
    park = jnp.stack(
        [jnp.full_like(t, 0.9995) * l1,
         jnp.mod(t * 0.6180339887, 1.0) * l1,
         jnp.mod(t * 0.3819660113, 1.0) * l1],
        axis=1,
    )
    q = jnp.where(in_sub[:, None], q, park)
    a1 = l1 / sub_cells / 3.0  # same a = cell/3 convention as level 0

    # ---- band term on the submesh (vacuum Hockney, traced size) ----------
    rho = cic_deposit(q, mr_sub, l1, sub_g, periodic=False)
    gp = 2 * sub_g
    h1 = l1 / sub_g
    rho_p = jnp.zeros((gp, gp, gp), jnp.float32).at[
        :sub_g, :sub_g, :sub_g
    ].set(rho)
    idx = jnp.arange(gp)
    d1 = jnp.minimum(idx, gp - idx).astype(jnp.float32) * h1
    r = jnp.sqrt(
        d1[:, None, None] ** 2 + d1[None, :, None] ** 2
        + d1[None, None, :] ** 2
    )
    safe_r = jnp.where(r > 0, r, 1.0)
    band0 = 2.0 / jnp.sqrt(jnp.pi) * (1.0 / a1 - 1.0 / jnp.asarray(a0))
    green = jnp.where(
        r > 0, -(erf(r / a1) - erf(r / jnp.asarray(a0))) / safe_r, -band0
    )
    phi_hat = jnp.fft.fftn(rho_p) * jnp.fft.fftn(green) * G
    # fftfreq with a traced spacing: scale the static unit frequencies
    k1 = (2.0 * jnp.pi * jnp.fft.fftfreq(gp).astype(jnp.float32)) / h1
    kx = k1[:, None, None]
    ky = k1[None, :, None]
    kz = k1[None, None, :]
    phi_hat = phi_hat / _cic_window(gp) ** 2
    ax = jnp.real(jnp.fft.ifftn(1j * kx * phi_hat))
    ay = jnp.real(jnp.fft.ifftn(1j * ky * phi_hat))
    az = jnp.real(jnp.fft.ifftn(1j * kz * phi_hat))
    acc_grid = -jnp.stack([ax, ay, az], axis=-1)[:sub_g, :sub_g, :sub_g]
    acc_band = cic_gather(acc_grid, q, l1, sub_g, periodic=False)

    # ---- short1: fine binned PP among the in-submesh rows -----------------
    table1, _, _, dropped1 = cell_bin_full(q, l1, sub_cells, sub_k)
    acc_s1, _ = short_range_acc(
        q, mr_sub, G, a1, l1, sub_cells, sub_k, eps,
        table=table1, n_overflow=jnp.int32(0),
    )
    n_sub = jnp.sum((dropped1 & in_sub).astype(jnp.int32))

    # ---- outlier rows: exact dense rr block vs ALL residual rows ----------
    # (the level-0 short kernel at a0, the exact term the dense path would
    # give these pairs). Reactions go to IN-SUBMESH rows only: out-out
    # pairs already appear once per ordered copy across the block rows.
    out = res_valid & ~in_sub
    oi, o_valid = take_rows(out, out_cap)
    po = pr[oi]  # [out_cap, 3]
    mo = jnp.where(o_valid, mr[oi], 0.0)
    a32 = jnp.asarray(a0, jnp.float32)
    eps2 = jnp.asarray(eps, jnp.float32) ** 2
    d_o = pr[None, :, :] - po[:, None, :]  # [out_cap, M, 3]
    r2o = jnp.sum(d_o * d_o, -1)
    s_o = jnp.sqrt(jnp.where(r2o + eps2 > 0, r2o + eps2, 1.0))
    w_o = jnp.where(
        (r2o > 0) & o_valid[:, None],
        _short_force_mag(s_o, a32, G) / s_o,
        0.0,
    )
    acc_out = jnp.einsum("om,omd->od", w_o * mr[None, :], d_o)
    w_in = w_o * jnp.where(in_sub[None, :], 1.0, 0.0)
    acc_react = -jnp.einsum("om,omd->md", w_in * mo[:, None], d_o)
    n_sub = n_sub + jnp.sum(out.astype(i32)) - jnp.sum(o_valid.astype(i32))

    total = jnp.where(in_sub[:, None], acc_band + acc_s1, 0.0) + acc_react
    total = total.at[oi].add(
        jnp.where(o_valid[:, None], acc_out, 0.0), mode="drop"
    )
    acc = jnp.zeros((n + 1, 3), jnp.float32)
    acc = acc.at[ridx_p].add(
        jnp.where(res_valid[:, None], total, 0.0), mode="drop"
    )
    return acc[:n], n_sub


@functools.partial(
    jax.jit,
    static_argnames=("g", "n_cells", "max_per_cell", "max_residual",
                     "deconvolve", "residual_mode", "sub_g", "sub_cells",
                     "sub_k"),
)
def p3m_acceleration(
    pos: jax.Array,  # [N, 3] in [0, box/2)^3 (isolated convention)
    mass: jax.Array,
    G,
    box_size: float,
    g: int = 64,
    n_cells: int = 16,
    max_per_cell: int = 32,
    eps=0.0,
    max_residual: int = 2048,
    deconvolve: bool = True,
    residual_mode: str = "dense",
    sub_g: int = 64,
    sub_cells: int = 16,
    sub_k: int = 64,
    green_hat: jax.Array | None = None,
):
    """Isolated-boundary P3M acceleration, [N, 3]. Returns
    (acc, n_uncorrected).

    The smoothing scale is a = cell/3 with cell = box/n_cells, so the
    short-range part vanishes (erfc(3) ~ 2e-5) beyond one cell and the
    27-neighborhood captures everything.

    Clustered scenes that overflow max_per_cell are handled adaptively: up
    to `max_residual` overflowing bodies get an exact residual short-range
    pass (_residual_short_acc) instead of silently degrading to mesh-only
    force. n_uncorrected counts bodies beyond that cap (0 = every body got
    its full short-range term); it is the value to gate on.

    residual_mode picks the residual-residual solver:
      'dense'    exact [M, M] block — right up to a few thousand overflow
                 bodies.
      'twolevel' TWO-LEVEL P3M: a refined submesh over the residual set
                 (band kernel FFT + fine binned PP, _residual_rr_twolevel)
                 replaces the M^2 block with an O(M) pass at ~PM-level
                 accuracy for those pairs; sub_g/sub_cells/sub_k size the
                 submesh. n_uncorrected then also counts residual bodies
                 dropped from the FINE binning (the no-silent-caps rule).
    """
    cell = box_size / n_cells
    a = cell / 3.0

    # ---- long range: PM with the erf-smoothed free-space Green's function
    # (isolated boundaries: out-of-box CIC weights dropped, never wrapped).
    # All transforms rfftn/irfftn via the shared solve; pass green_hat
    # (= isolated_green_hat(box, g, a, smoothed=True)) from a frame loop
    # to skip re-transforming the [2g]^3 Green's function per eval.
    from nbx.ops.pm import _isolated_solve_r, isolated_green_hat

    rho = cic_deposit(pos, mass, box_size, g, periodic=False)
    if green_hat is None:
        green_hat = isolated_green_hat(box_size, g, a, smoothed=True)
    acc_grid = _isolated_solve_r(rho, G, box_size, g, green_hat, deconvolve)
    acc_long = cic_gather(acc_grid, pos, box_size, g, periodic=False)

    # ---- short range: exact pairs within the cell neighborhood
    table, _, n_overflow, dropped = cell_bin_full(
        pos, box_size, n_cells, max_per_cell
    )
    acc_short, _ = short_range_acc(
        pos, mass, G, a, box_size, n_cells, max_per_cell, eps,
        table=table, n_overflow=n_overflow,
    )
    # ---- adaptive residual: overflowing bodies get an exact pass ----------
    res_idx, res_valid = take_rows(dropped, max_residual)
    n_uncorrected = jnp.maximum(n_overflow - max_residual, 0)
    acc_res = _residual_short_acc(
        pos, mass, G, a, eps, box_size, n_cells, table, res_idx,
        res_valid, include_rr=(residual_mode == "dense"),
    )
    if residual_mode == "twolevel":
        acc_rr, n_sub = _residual_rr_twolevel(
            pos, mass, G, eps, a, res_idx, res_valid, sub_g, sub_cells,
            sub_k,
        )
        acc_res = acc_res + acc_rr
        n_uncorrected = n_uncorrected + n_sub
    elif residual_mode != "dense":
        raise ValueError(f"residual_mode must be dense|twolevel, got "
                         f"{residual_mode!r}")
    return acc_long + acc_short + acc_res, n_uncorrected


@functools.partial(
    jax.jit,
    static_argnames=("n_steps", "g", "n_cells", "max_per_cell"),
)
def p3m_kdk_scan(
    pos, vel, mass, G, box_size: float, h, n_steps: int,
    g: int = 64, n_cells: int = 16, max_per_cell: int = 32, eps=0.0,
):
    """KDK leapfrog under lax.scan with P3M forces. Returns
    (pos, vel, max_uncorrected_seen) — nonzero means some step had more
    than max_residual bodies overflow their cells AND exhaust the residual
    pass, i.e. some short-range corrections were actually dropped (size
    max_per_cell or max_residual up)."""

    def force(p):
        return p3m_acceleration(
            p, mass, G, box_size, g, n_cells, max_per_cell, eps
        )

    def body(c, _):
        p, v, a, ovf = c
        v = v + a * (0.5 * h)
        p = p + v * h
        a, o = force(p)
        v = v + a * (0.5 * h)
        return (p, v, a, jnp.maximum(ovf, o)), None

    a0, o0 = force(pos)
    (p, v, _, ovf), _ = jax.lax.scan(
        body, (pos, vel, a0, o0), None, length=n_steps
    )
    return p, v, ovf
