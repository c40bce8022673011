"""K7 and K8 (ops/cg_merged.py) and solve_cg_merged: the plain versions on
the CPU against the merged solver's torch expressions as they stood before
the kernels (kept here), the solver against the JAX solve_cg_merged, its
mixed bf16 / f32 case against the torch-expression solver bit for bit, the
wrappers' refusals, and the CUDA kernels against their plain versions on a
card (skipped without one)."""

import re

import numpy as np
import pytest
import torch

import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch.ops import cg_merged as cm
from deal_and_ceed_on_gpu_torch.solvers.cg import safe_div

try:
    import jax.numpy as jnp

    import deal_and_ceed_on_gpu_tpu as jx
except ImportError:  # the card's machine has no jax: only the cuda-marked tests run there
    jnp = None

N = 37  # an odd length: the kernels' scalar head and tail on the card

# (g and h, x d and diag, dots): the kernels' pairs, the mixed one with a diagonal only
TYPES = {
    "f64": (torch.float64, torch.float64, torch.float64),
    "f32": (torch.float32, torch.float32, torch.float32),
    "bf16": (torch.bfloat16, torch.bfloat16, torch.float32),
    "mixed": (torch.bfloat16, torch.float32, torch.float32),
}
TYPE_DIAG = [(t, dg) for t in TYPES for dg in (False, True) if t != "mixed" or dg]
UPDATE_MODES = ("plain", "two-step", "odd-stop", "no-x")


# --- the merged solver's torch expressions before the kernels ------------


def parent_dots7(d, g, h, diag, w, dd):
    """``dots7`` of the parent solver (no comm)."""

    def dot(u, v):
        return torch.dot(u.reshape(-1), v.reshape(-1))

    def wt(u):
        return u if w is None else u * w

    dq, gq, hq = d.to(dd), g.to(dd), h.to(dd)
    hw = wt(hq)
    dh, hh, gh, gg = dot(dq, hw), dot(hq, hw), dot(gq, hw), dot(gq, wt(gq))
    if diag is None:
        return dh, hh, gh, gg, gh, hh, gg
    mq = diag.to(dd)
    mh = mq * hw
    return dh, hh, gh, gg, dot(gq, mh), dot(hq, mh), dot(gq, mq * wt(gq))


def parent_scalars(s):
    s0, s1, s2, s3, s4, s5, s6 = s
    alpha = safe_div(s6, s0)
    res = torch.sqrt(torch.clamp_min(s3 + 2.0 * alpha * s2 + alpha * alpha * s1, 0.0))
    beta = safe_div(alpha * (s4 + alpha * s5), s6)
    return alpha, res, beta


def parent_update(x, g, d, h, diag, alpha, beta, alpha_prev, beta_prev, mode, dt):
    """The parent solver's update lines; returns the new (x, g, d)."""

    def mdiag(v):
        return v if diag is None else diag * v

    a = alpha.to(dt)
    if mode in ("plain", "odd-stop"):
        x = x + a * d
    elif mode == "two-step":
        ratio = safe_div(alpha_prev, beta_prev).to(dt)
        x = x + (a + ratio) * d + ratio * mdiag(g)
    g = g + a * h
    d = beta.to(dt) * d - mdiag(g)
    return x, g, d


def parent_solve(A, b, control, diag=None, x0=None, deferred_x_update=False, dot_dtype=None):
    """The parent solve_cg_merged (one device), from those pieces."""
    dt, dd = b.dtype, dot_dtype or b.dtype
    if x0 is None:
        x, g = torch.zeros_like(b), -b
    else:
        x, g = x0, A(x0) - b
    gq = g.to(dd)
    res0 = torch.sqrt(torch.dot(gq.reshape(-1), gq.reshape(-1)))
    d = -(g if diag is None else diag * g)
    alpha = beta = torch.zeros((), dtype=dd)
    it, res0_h = 0, float(res0)
    if not control.continue_pred(it, res0_h, res0_h):
        return x, it
    while True:
        it += 1
        alpha_prev, beta_prev = alpha, beta
        h = A(d)
        s = parent_dots7(d, g, h, diag, None, dd)
        alpha, res, beta = parent_scalars(s)
        will_stop = not control.continue_pred(it, float(res), res0_h)
        if not deferred_x_update:
            mode = "plain"
        elif it % 2 == 0:
            mode = "two-step"
        else:
            mode = "odd-stop" if will_stop else "no-x"
        x, g, d = parent_update(x, g, d, h, diag, alpha, beta, alpha_prev, beta_prev, mode, dt)
        if will_stop:
            return x, it


# --- inputs ----------------------------------------------------------------


def _vectors(kind, diag, weight, seed=0, n=N, device="cpu"):
    """x, g, d, h, diag, weight of one type pair, from a seed."""
    tg, tx, dd = TYPES[kind]
    rng = np.random.default_rng(seed)

    def vec(t, scale=1.0):
        return torch.as_tensor(scale * rng.standard_normal(n), dtype=torch.float64).to(t).to(device)

    x, g, d, h = vec(tx), vec(tg), vec(tx), vec(tg)
    m = torch.as_tensor(0.5 + rng.random(n)).to(tx).to(device) if diag else None
    w = torch.as_tensor((rng.random(n) > 0.25).astype(np.float64)).to(dd).to(device) if weight else None
    return x, g, d, h, m, w


def _summaries(dd, device="cpu", seed=3):
    """A summary and a previous one with random sums and their scalars."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        s = tuple(torch.tensor(v, dtype=dd, device=device) for v in 1.0 + rng.random(7))
        out.append(torch.stack([*s, *cm.merged_scalars_plain(s)]))
    return out


# --- the plain versions against the parent's expressions -------------------


@pytest.mark.parametrize("mode", ("init",) + UPDATE_MODES)
@pytest.mark.parametrize("weight", [False, True], ids=["w-none", "w-given"])
@pytest.mark.parametrize("kind,diag", TYPE_DIAG, ids=[f"{t}-{'diag' if dg else 'ident'}" for t, dg in TYPE_DIAG])
def test_plain_versions_equal_parent_expressions(kind, diag, weight, mode):
    x, g, d, h, m, w = _vectors(kind, diag, weight)
    dd = TYPES[kind][2]
    # K8's plain version and the finisher's scalars
    want = parent_dots7(d, g, h, m, w, dd)
    got = cm.merged_dots_plain(d, g, h, m, w, dd)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    summary = cm.merged_dots(d, g, h, m, w, dd)
    alpha, res, beta = parent_scalars(want)
    assert summary.dtype == dd and summary.shape == (cm.SUMMARY,)
    assert torch.equal(summary[:7], torch.stack(want))
    assert torch.equal(summary[cm.S_ALPHA], alpha) and torch.equal(summary[cm.S_BETA], beta)
    assert torch.equal(summary[cm.S_RES], res) and torch.equal(summary[cm.S_RATIO], safe_div(alpha, beta))
    # K7's plain version through the wrapper, in place
    scal, prev = _summaries(dd)
    xs, gs, ds = x.clone(), g.clone(), d.clone()
    if mode == "init":
        cm.merged_update(None, gs, ds, None, m, None, None, "init")
        assert torch.equal(ds, -(g if m is None else m * g)) and torch.equal(gs, g)
        return
    cm.merged_update(xs, gs, ds, h, m, scal, prev, mode)
    wx, wg, wd = parent_update(x, g, d, h, m, scal[cm.S_ALPHA], scal[cm.S_BETA], prev[cm.S_ALPHA],
                               prev[cm.S_BETA], mode, g.dtype)
    assert (wx.dtype, wg.dtype, wd.dtype) == (xs.dtype, gs.dtype, ds.dtype)
    assert torch.equal(xs, wx) and torch.equal(gs, wg) and torch.equal(ds, wd)


# --- the solver --------------------------------------------------------------


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n))
    return m @ m.T / n + np.eye(n)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("case", ["jacobi-weight", "deferred-3n"])
def test_solver_matches_jax(case, k):
    """Against the JAX solve_cg_merged at k fixed iterations: a Jacobi
    diagonal with a dot weight, and the deferred x update on a [3, n]
    right-hand side; x to 1e-12 in f64, the same count."""
    if jnp is None:
        pytest.skip("jax is not installed")
    n = 24
    a = _spd(n, seed=k)
    rng = np.random.default_rng(10 + k)
    if case == "jacobi-weight":
        b = rng.standard_normal(n)
        diag = 1.0 / np.diag(a)
        weight = (rng.random(n) > 0.3).astype(np.float64)
        kw_t = dict(diag=torch.as_tensor(diag), dot_weight=torch.as_tensor(weight))
        kw_j = dict(diag=jnp.asarray(diag), dot_weight=jnp.asarray(weight))
        apply_t, apply_j = (lambda v: torch.as_tensor(a) @ v), (lambda v: jnp.asarray(a) @ v)
    else:
        b = rng.standard_normal((3, n))
        kw_t = kw_j = dict(deferred_x_update=True)
        apply_t, apply_j = (lambda v: v @ torch.as_tensor(a).T), (lambda v: v @ jnp.asarray(a).T)
    xt, it_t = pt.solve_cg_merged(apply_t, torch.as_tensor(b), pt.IterationNumberControl(k, 0.0), **kw_t)
    xj, it_j = jx.solve_cg_merged(apply_j, jnp.asarray(b), jx.IterationNumberControl(k, 0.0), **kw_j)
    assert it_t["n_iterations"] == int(it_j["n_iterations"]) == k
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("deferred", [False, True])
def test_solver_leaves_inputs_unchanged(deferred):
    """K7 updates the solver's own x, g and d: b, x0, the diagonal and the
    weight come back as they went in, and an operator that returns its
    input (h aliasing d) still solves as an out-of-place one does."""
    n = 20
    a = torch.as_tensor(_spd(n, seed=5))
    rng = np.random.default_rng(6)
    b, x0 = torch.as_tensor(rng.standard_normal(n)), torch.as_tensor(rng.standard_normal(n))
    diag, w = torch.as_tensor(0.5 + rng.random(n)), torch.ones(n, dtype=torch.float64)
    kept = [t.clone() for t in (b, x0, diag, w)]
    control = pt.IterationNumberControl(5, 0.0)
    x, info = pt.solve_cg_merged(lambda v: a @ v, b, control, diag=diag, x0=x0, deferred_x_update=deferred,
                                 dot_weight=w)
    assert all(torch.equal(t, k) for t, k in zip((b, x0, diag, w), kept))
    assert x.data_ptr() != x0.data_ptr() and info["n_iterations"] == 5
    # the identity operator hands back d itself
    xi, _ = pt.solve_cg_merged(lambda v: v, b, control, deferred_x_update=deferred)
    xr, _ = parent_solve(lambda v: v, b, control, deferred_x_update=deferred)
    assert torch.equal(xi, xr) and torch.equal(b, kept[0])


@pytest.mark.parametrize("backend", ["separable", "stencil"])
def test_mixed_bf16_f32_matches_parent(backend):
    """IR's bf16 inner solve: bf16 vectors with the f32 Jacobi diagonal.
    torch's promotion makes d and x f32 while g and h stay bf16; the solver
    returns the parent's x (type and bits) and count."""
    space = pt.FESpace.create(pt.BrickMesh((3, 3, 3)), 3, dtype=torch.float32, device="cpu")
    op = pt.PoissonOperator(space, backend=backend, stream_dtype=torch.bfloat16)
    diag = op.jacobi_preconditioner()
    b = torch.as_tensor(np.random.default_rng(2).standard_normal(space.n_dofs), dtype=torch.float32).to(
        torch.bfloat16)
    for control in (pt.ReductionControl(40, tolerance=0.0, reduction=1e-3), pt.IterationNumberControl(6, 0.0)):
        x, info = pt.solve_cg_merged(op.vmult, b, control, diag=diag, dot_dtype=torch.float32)
        want, it = parent_solve(op.vmult, b, control, diag=diag, dot_dtype=torch.float32)
        assert x.dtype == want.dtype == torch.float32
        assert torch.equal(x, want) and info["n_iterations"] == it


def test_wrappers_refuse():
    x, g, d, h, m, w = _vectors("f64", True, True)
    scal, prev = _summaries(torch.float64)
    ok = dict(x=x, g=g, d=d, h=h, diag=m, scal=scal, prev=prev, mode="plain")
    cm.merged_update(**ok)
    bad = {
        "shape": dict(h=h[:-1]),
        "type": dict(h=h.float()),
        "x type": dict(x=x.float()),
        "non-contiguous": dict(d=torch.stack([d, d], 1)[:, 0]),
        "h overlaps g": dict(h=g),
        "diag overlaps d": dict(diag=d),
        "x is d": dict(x=d),
        "summary": dict(scal=scal[:7]),
        "summary types": dict(scal=scal.float(), mode="two-step"),
        "mode": dict(mode="twostep"),
        "device": dict(g=torch.empty(N, dtype=torch.float64, device="meta")),
    }
    for name, change in bad.items():
        with pytest.raises(ValueError):
            cm.merged_update(**dict(ok, **change))
    with pytest.raises(ValueError):
        cm.merged_update(None, g, g, None, None, None, None, "init")  # d = -g into g
    for change in (dict(h=h[:-1]), dict(d=torch.stack([d, d], 1)[:, 0]), dict(weight=w[:-1]),
                   dict(weight=w.float()), dict(h=h.to(device="meta")), dict(out=torch.empty(7)),
                   dict(d=d.to(device="meta"), g=g.to(device="meta"), h=h.to(device="meta"), diag=None, weight=None)):
        with pytest.raises(ValueError):
            cm.merged_dots(**dict(dict(d=d, g=g, h=h, diag=m, weight=w, dot_dtype=torch.float64), **change))


# --- K8's workspace and grid --------------------------------------------------


SHAPES = {"n": (N,), "3n": (3, N)}


@pytest.mark.parametrize("shape", SHAPES, ids=list(SHAPES))
@pytest.mark.parametrize("weight", [False, True], ids=["w-none", "w-full"])
@pytest.mark.parametrize("kind,diag", TYPE_DIAG, ids=[f"{t}-{'diag' if dg else 'ident'}" for t, dg in TYPE_DIAG])
def test_dots_workspace_equals_none(kind, diag, weight, shape):
    """merged_dots with a workspace (the solver's route: its d, g, diagonal
    and weight checked once, h at every call, the summaries in turn) equals
    merged_dots without one, bit for bit."""
    x, g, d, h, m, w = _vectors(kind, diag, weight, n=int(np.prod(SHAPES[shape])))
    g, d, h, m, w = (None if v is None else v.reshape(SHAPES[shape]) for v in (g, d, h, m, w))
    dd = TYPES[kind][2]
    ws = cm.DotsWorkspace(dd, "cpu")
    ws.summaries.fill_(float("nan"))
    first = cm.merged_dots(d, g, h, m, w, dd, workspace=ws)
    assert torch.equal(first, cm.merged_dots(d, g, h, m, w, dd))
    h2 = 2 * h
    second = cm.merged_dots(d, g, h2, m, w, dd, workspace=ws)
    assert second.data_ptr() != first.data_ptr()  # the other summary: first stays as it was
    assert torch.equal(second, cm.merged_dots(d, g, h2, m, w, dd))
    assert torch.equal(first, cm.merged_dots(d, g, h, m, w, dd))
    assert torch.equal(cm.merged_dots(d, g, h, m, w, dd, workspace=ws), first)  # the first's row again


def test_dots_workspace_refused():
    """A workspace of another dtype or device, or with too few rows, and an
    h of another shape, type, device or layout once d and g are checked."""
    x, g, d, h, m, w = _vectors("f64", True, True)
    args = dict(d=d, g=g, h=h, diag=m, weight=w, dot_dtype=torch.float64)
    for ws in (cm.DotsWorkspace(torch.float32, "cpu"), cm.DotsWorkspace(torch.float64, "meta"),
               cm.DotsWorkspace(torch.float64, "cpu", rows=0), torch.empty(cm.DOTS_WAVE, 7, dtype=torch.float64)):
        with pytest.raises(ValueError):
            cm.merged_dots(**args, workspace=ws)
    big = torch.zeros(cm.DOT_POINTS_PER_BLOCK + 1, dtype=torch.float64)
    with pytest.raises(ValueError):  # two blocks' rows wanted
        cm.merged_dots(big, big, big, workspace=cm.DotsWorkspace(torch.float64, "cpu", rows=1))
    ws = cm.DotsWorkspace(torch.float64, "cpu")
    cm.merged_dots(**args, workspace=ws)
    for bad in (h[:-1], h.float(), torch.stack([h, h], 1)[:, 0], h.to(device="meta")):
        with pytest.raises(ValueError):
            cm.merged_dots(**dict(args, h=bad), workspace=ws)
    with pytest.raises(ValueError):  # a new d is checked in full
        cm.merged_dots(**dict(args, d=d[:-1]), workspace=ws)


def test_dots_blocks_from_n_alone():
    """K8's block count (the Python mirror of csrc/cg_merged.cu's): a block
    per DOT_POINTS_PER_BLOCK points, at most DOTS_WAVE, from n alone; the
    constants are the source's."""
    p = cm.DOT_POINTS_PER_BLOCK
    ns = [1, 2, p - 1, p, p + 1, 100_003, (cm.DOTS_WAVE - 1) * p, cm.DOTS_WAVE * p - 1, cm.DOTS_WAVE * p,
          cm.DOTS_WAVE * p + 1, 12_468_001, 131_892_801]
    blocks = [cm.dots_blocks(n) for n in ns]
    assert blocks == [min(-(-n // p), cm.DOTS_WAVE) for n in ns]
    assert blocks[-4:] == [cm.DOTS_WAVE] * 4 and all(1 <= b <= cm.DOTS_WAVE for b in blocks)
    assert blocks == sorted(blocks)
    src = cm.SOURCE.read_text()
    assert re.search(r"constexpr int DOTS_MIN_BLOCKS = (\d+);", src).group(1) == str(cm.DOTS_WAVE // 132)
    assert "constexpr int DOT_WAVE = 132 * DOTS_MIN_BLOCKS;" in src
    assert re.search(r"constexpr long long DOT_POINTS_PER_BLOCK = (\d+);", src).group(1) == str(p)


def test_solver_summaries_stay():
    """The solve's returned res_norm (a view of its last summary) is not
    overwritten after it returns, by a later solve or anything else."""
    n = 20
    a = torch.as_tensor(_spd(n, seed=7))
    b = torch.as_tensor(np.random.default_rng(8).standard_normal(n))
    _, info = pt.solve_cg_merged(lambda v: a @ v, b, pt.IterationNumberControl(4, 0.0))
    kept = info["res_norm"].clone()
    pt.solve_cg_merged(lambda v: a @ v, 2 * b, pt.IterationNumberControl(5, 0.0))
    assert torch.equal(info["res_norm"], kept)


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K7 and K8 have no CPU mode")
    return torch.device("cuda")


DOT_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}  # K5's, of |u| |v|; scalars 1e3 times that


def _dots_check(d, g, h, m, w, dd):
    """K8 + finisher from a NaN-filled summary against the plain version."""
    got = cm.merged_dots(d, g, h, m, w, dd, out=torch.full((cm.SUMMARY,), float("nan"), dtype=dd, device=g.device))
    s = cm.merged_dots_plain(d, g, h, m, w, dd)
    want = torch.stack([*s, *cm.merged_scalars_plain(s)])
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    nd, ng, nh = (float(torch.linalg.vector_norm(v.to(dd))) for v in (d, g, h))
    nm = 1.0 if m is None else float(m.abs().max())
    scale = [nd * nh, nh * nh, ng * nh, ng * ng, nm * ng * nh, nm * nh * nh, nm * ng * ng]
    for k in range(7):
        assert abs(float(got[k]) - float(want[k])) <= DOT_TOL[dd] * max(scale[k], 1e-300), k
    for k in range(7, cm.SUMMARY):
        assert abs(float(got[k]) - float(want[k])) <= 1e3 * DOT_TOL[dd] * max(abs(float(want[k])), 1e-300), k


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 4097, 100_003])
@pytest.mark.parametrize("kind,diag", TYPE_DIAG)
def test_k7_k8_match_plain_on_card(cuda_device, kind, diag, n):
    """K7 bit for bit in every mode, K8 and its finisher to K5's dot
    tolerances, with and without a weight, at lengths around the packs."""
    dd = TYPES[kind][2]
    for weight in (False, True):
        x, g, d, h, m, w = _vectors(kind, diag, weight, seed=n, n=n, device=cuda_device)
        _dots_check(d, g, h, m, w, dd)
    scal, prev = _summaries(dd, device=cuda_device)
    for mode in ("init",) + UPDATE_MODES:
        got = [v.clone() for v in (x, g, d)]
        want = [v.clone() for v in (x, g, d)]
        cm.merged_update(*got, h, m, scal, prev, mode)
        cm.merged_update_plain(*want, h, m, scal, prev, mode)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), mode


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f64", "bf16", "mixed"])
def test_k7_k8_on_unaligned_views_on_card(cuda_device, kind):
    """Views one element off a 16-byte boundary, alike (the packs after a
    scalar head) and unlike (the scalar path), and a [3, n] vector."""
    n = 4099
    dd = TYPES[kind][2]
    x, g, d, h, m, _ = _vectors(kind, True, False, seed=1, n=n + 2, device=cuda_device)
    scal, prev = _summaries(dd, device=cuda_device)
    for off in ((1, 1, 1, 1, 1), (1, 0, 1, 0, 2), (0, 1, 2, 1, 0)):
        views = [v[o : o + n] for v, o in zip((x, g, d, h, m), off)]
        _dots_check(views[2], views[1], views[3], views[4], None, dd)
        for mode in UPDATE_MODES:
            bx, bg, bd = (v.clone() for v in (x, g, d))
            got = [b[o : o + n] for b, o in zip((bx, bg, bd), off)]
            want = [v.clone() for v in got]
            cm.merged_update(*got, views[3], views[4], scal, prev, mode)
            cm.merged_update_plain(*want, views[3], views[4], scal, prev, mode)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (off, mode)
            assert torch.equal(bg[: off[1]], g[: off[1]]) and torch.equal(bg[off[1] + n :], g[off[1] + n :])
    v3 = [t[: 3 * 1365].reshape(3, 1365) for t in (x, g, d, h, m)]
    _dots_check(v3[2], v3[1], v3[3], v3[4], None, dd)


# K8's grid edges: a block per DOT_POINTS_PER_BLOCK points up to one wave;
# one whole trip of U packs of V points per thread at DOTS_WAVE * 256 * U * V
EDGE_LENGTHS = (100_003, (cm.DOTS_WAVE - 1) * cm.DOT_POINTS_PER_BLOCK, (cm.DOTS_WAVE - 1) * cm.DOT_POINTS_PER_BLOCK + 1,
                *(cm.DOTS_WAVE * 256 * uv + e for uv in (8, 16, 32) for e in (-1, 1)))


def _dots_on_workspace(d, g, h, m, w, dd, ws):
    """K8 on a workspace from NaN-filled summaries: to K5's tolerances, the
    ticket back at 0, a second call the same bits."""
    ws.summaries.fill_(float("nan"))
    got = cm.merged_dots(d, g, h, m, w, dd, workspace=ws)
    again = cm.merged_dots(d, g, h, m, w, dd, workspace=ws)
    torch.cuda.synchronize()
    assert int(ws.ticket.item()) == 0
    assert torch.equal(got, again) and got.data_ptr() != again.data_ptr()
    _dots_check(d, g, h, m, w, dd)
    assert torch.equal(got, cm.merged_dots(d, g, h, m, w, dd))


@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGE_LENGTHS)
@pytest.mark.parametrize("kind,diag", TYPE_DIAG)
def test_k8_wave_edges_on_card(cuda_device, kind, diag, n):
    """K8 at the edges of its wave and of its unrolled trips, with and
    without a weight, on a workspace: to K5's tolerances, the ticket at 0
    after every call, repeated calls bit for bit."""
    dd = TYPES[kind][2]
    ws = cm.DotsWorkspace(dd, cuda_device)
    for weight in (False, True):
        _, g, d, h, m, w = _vectors(kind, diag, weight, seed=n, n=n, device=cuda_device)
        _dots_on_workspace(d, g, h, m, w, dd, ws)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f64", "bf16", "mixed"])
def test_k8_workspace_on_unaligned_views_on_card(cuda_device, kind):
    """K8 on a workspace on views one element off a 16-byte boundary, alike
    and unlike, at a length with whole trips and a ragged tail."""
    n = cm.DOTS_WAVE * 256 * 16 + 5
    dd = TYPES[kind][2]
    _, g, d, h, m, _ = _vectors(kind, True, False, seed=2, n=n + 2, device=cuda_device)
    ws = cm.DotsWorkspace(dd, cuda_device)
    for off in ((1, 1, 1, 1), (1, 0, 2, 1), (0, 1, 1, 0)):
        v = [t[o : o + n] for t, o in zip((g, d, h, m), off)]
        _dots_on_workspace(v[1], v[0], v[2], v[3], None, dd, ws)


@pytest.mark.cuda
def test_cuda_solve_never_runs_plain(cuda_device, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")

    for name in ("merged_update_plain", "merged_dots_plain", "merged_scalars_plain"):
        monkeypatch.setattr(cm, name, refuse)
    space = pt.FESpace.create(pt.BrickMesh.bp5_cycle(4), 3, dtype=torch.float64, device=cuda_device)
    op = pt.PoissonOperator(space, backend="separable")
    b = torch.ones(space.n_dofs, dtype=torch.float64, device=cuda_device)
    before = (cm.UPDATE_LAUNCHES, cm.DOTS_LAUNCHES, cm.FINISH_LAUNCHES)
    for deferred in (False, True):
        x, info = pt.solve_cg_merged(op.vmult, b, pt.IterationNumberControl(7, 0.0), diag=op.jacobi_preconditioner(),
                                     deferred_x_update=deferred)
        assert info["n_iterations"] == 7 and bool(torch.isfinite(x).all())
    # two launches an iteration beside the apply, K7 and K8 (no finisher on one device); one K7 and K8 more to start
    assert (cm.UPDATE_LAUNCHES - before[0], cm.DOTS_LAUNCHES - before[1], cm.FINISH_LAUNCHES - before[2]) == (16, 16, 0)


@pytest.mark.cuda
def test_bp5_cycle10_count_on_card(cuda_device):
    """BP5 cycle 10 solved by pcg-merged on K1 and K7 / K8 takes the
    CPU's count (run_cycle's 59, the reference's golden)."""
    from deal_and_ceed_on_gpu_torch.drivers.bp5 import run_cycle

    counts = {}
    for device, backend in (("cpu", "separable"), ("cuda", "stencil")):
        r = run_cycle(10, backend=backend, device=device, dtype="float64", modes=("pcg-merged",), n_repetitions=1)
        counts[device] = r["n_iterations"]["pcg-merged"]
    assert counts["cpu"] == counts["cuda"] == 59
