"""The encoder's backward reads the forward's Q|K|V instead of computing it
again (``ops/news_encoder.py``), on the CPU through the plain versions the
kernels are held against: the tiled route's backward (``tiled_bwd_core``)
and the per-block kernel's plain version (``bwd_core_reference``) given the
forward's Q|K|V return what they return when they compute it, bit for bit,
in fp32 and bf16, at a T the kernels' instances take (20) and one past them
(50); ``_forward`` returns a Q|K|V only when asked; ``NewsEncoderFunction``
asks for it only when a gradient will follow (not under ``no_grad``, not
when no input needs a gradient), hands the same buffer from K1 (or T1) to
its backward once, and a second backward over the retained graph computes
it again, to the same gradients."""
import numpy as np
import pytest
import torch

from ebnerd_tpu_torch.ops import news_encoder as port
from ebnerd_tpu_torch.ops import philox

torch.set_num_threads(1)

SEED, KEEP = (7 << 40) + 11, 0.8
DTYPES = pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
# n, t, din, heads, head_dim, a, n_valid: T 20 (the narrow instance's), T 50 (the tiled route's)
SHAPES = pytest.mark.parametrize("n,t,din,heads,head_dim,a,nv", [
    (5, 20, 32, 4, 16, 48, 4), (3, 50, 24, 2, 8, 40, 2)], ids=["t20", "t50"])


def _setup(cdt, n, t, din, heads, head_dim, a, nv):
    """x [N, T, Din] and the weights in fp32, the packed weights, the
    kernels' x and dropout (Philox on the attention output at keep 0.8;
    fp32 also on x, which the kernels draw: bf16 draws stream 0 on the card
    only), and a cotangent zero past the valid articles."""
    rng = np.random.default_rng(0)
    d = heads * head_dim
    mk = lambda *s, sc=0.3: torch.from_numpy(rng.standard_normal(s, dtype=np.float32) * sc)
    x = mk(n, t, din, sc=1.0).to(cdt)
    ws = [mk(din, d), mk(din, d), mk(din, d), mk(d, a), mk(a), mk(a, 1)]
    packed = port.pack_weights(*ws, num_heads=heads, compute_dtype=cdt)
    emb_keep = KEEP if cdt == torch.float32 else 1.0
    drop = port.dropout_config(n, t, d, KEEP, emb_keep, SEED)
    xin, _, drop_in = port.kernel_input(x, nv, drop)
    g = torch.sin(torch.arange(n * d, dtype=torch.float32).reshape(n, d))
    g[nv:] = 0
    return x, ws, packed, xin, drop_in, g, emb_keep


def _recomputed_qkv(x, packed, t, nv):
    """Q|K|V [nv * T, P] in the compute dtype as ``bwd_core_reference``
    computes it when it is given none: round(x Wq), round(x Wk), round(x Wv)
    from x with its stream-0 mask applied, packed into the panel layout."""
    cdt, heads, d = packed.wqkv.dtype, packed.num_heads, packed.w_att.shape[0]
    xv = x[:nv * t].float()
    parts = [(xv @ w.float()).to(cdt) for w in port.unpack_qkv(packed.wqkv, heads, d)]
    return port._pack_panels(parts, heads)


def _counts(*kernels) -> list:
    return [k.launches for k in kernels]


@DTYPES
@SHAPES
def test_tiled_bwd_core_given_the_forward_qkv_equals_its_recompute(cdt, n, t, din, heads,
                                                                  head_dim, a, nv):
    _, _, packed, xin, drop_in, g, _ = _setup(cdt, n, t, din, heads, head_dim, a, nv)
    before = _counts(port.tiled_forward.saved_qkv, port.tiled_bwd_core.saved_qkv,
                     port.tiled_bwd_core.recomputed_qkv)
    out, qkv = port.tiled_forward(xin, packed, nv, drop_in, n=n, t=t, save_qkv=True)
    assert torch.equal(out, port.tiled_forward(xin, packed, nv, drop_in, n=n, t=t))
    assert torch.equal(qkv, port.tiled_qkv(xin, packed, drop_in, n=n, t=t, nv=nv))
    kept = qkv.clone()
    want = port.tiled_bwd_core(xin, packed, g, nv, drop_in, n=n, t=t)
    got = port.tiled_bwd_core(xin, packed, g, nv, drop_in, n=n, t=t, qkv=qkv)
    for name, u, v in zip(("dqkv", "o_c", "dz_c", "db_part", "dq_part"), got, want):
        assert u.dtype == v.dtype and u.shape == v.shape and torch.equal(u, v), name
    assert torch.equal(qkv, kept)  # T4 writes its own dQ|dK|dV
    after = _counts(port.tiled_forward.saved_qkv, port.tiled_bwd_core.saved_qkv,
                    port.tiled_bwd_core.recomputed_qkv)
    assert [u - v for u, v in zip(after, before)] == [1, 1, 1]
    with pytest.raises(ValueError, match="qkv must be"):
        port.tiled_bwd_core(xin, packed, g, nv, drop_in, n=n, t=t, qkv=qkv[1:])


@DTYPES
@SHAPES
def test_bwd_core_reference_given_the_forward_qkv_equals_its_recompute(cdt, n, t, din, heads,
                                                                      head_dim, a, nv):
    _, _, packed, xin, drop_in, g, emb_keep = _setup(cdt, n, t, din, heads, head_dim, a, nv)
    rows = nv * t
    xc = xin.clone()
    if drop_in.thr_emb:  # the plain version takes x with its stream-0 mask applied
        xc[:rows] *= philox.mask(SEED, philox.STREAM_EMB, rows, xin.shape[1], emb_keep)
    drop = drop_in._replace(thr_emb=0)
    # the forward's Q|K|V from the reference's own products, and another in its place
    qkv = _recomputed_qkv(xc, packed, t, nv)
    other = _recomputed_qkv(xc.flip(0), packed, t, nv)
    kw = dict(t=t, nv=nv, drop=drop, seed=SEED, keep_prob=KEEP)
    want = port.bwd_core_reference(xc, packed, g, **kw)
    got = port.bwd_core_reference(xc, packed, g, **kw, qkv=qkv)
    for name, u, v in zip(("dqkv", "o_c", "dz_c", "db_part", "dq_part"), got, want):
        assert u.dtype == v.dtype and u.shape == v.shape and torch.equal(u, v), name
    # the Q|K|V it is given is the one it uses
    moved = port.bwd_core_reference(xc, packed, g, **kw, qkv=other)
    assert not torch.equal(moved[0], want[0])


def _cpu_packing(monkeypatch):
    monkeypatch.setattr(port, "_packed_for", lambda x, weights, packed, heads, cdt:
                        port.pack_weights(*weights, num_heads=heads, compute_dtype=cdt))


@DTYPES
def test_forward_returns_qkv_only_when_asked(monkeypatch, cdt):
    """The tiled route (plain versions of T1-T3) and K1 (a recorder): the
    ninth value is None without ``save_qkv``, and with it T1's output or
    the buffer K1 was handed to write, [N*T, P] in the compute dtype."""
    n, t, din, heads, head_dim, a, nv = 5, 20, 32, 4, 16, 48, 4
    x, ws, packed, xin, drop_in, _, emb_keep = _setup(cdt, n, t, din, heads, head_dim, a, nv)
    _cpu_packing(monkeypatch)
    args = (ws, None, heads, cdt, nv, KEEP, emb_keep, SEED, None)
    base = port._forward(x, *args, force_tiled=True)
    saved = port._forward(x, *args, force_tiled=True, save_qkv=True)
    assert len(base) == len(saved) == 9 and base[7] is True and saved[7] is True
    assert base[8] is None
    assert torch.equal(saved[0], base[0])
    assert torch.equal(saved[8], port.tiled_qkv(xin, packed, drop_in, n=n, t=t, nv=nv))
    handed = []

    def fake_launch(lib, xin_, packed_, nv_, drop, *, n, t, nv_dev=None, qkv_out=None):
        handed.append(qkv_out)
        return torch.zeros(n, heads * head_dim)

    monkeypatch.setattr(port, "launch", fake_launch)
    monkeypatch.setattr(port, "_library", lambda: None)
    monkeypatch.setattr(port, "_route", lambda *args_, **kw: "narrow")
    assert port._forward(x, *args)[8] is None and handed == [None]
    k1 = port._forward(x, *args, save_qkv=True)
    assert k1[7] is False and k1[8] is handed[1]
    assert k1[8].shape == (n * t, packed.wqkv.shape[1]) and k1[8].dtype == cdt


def _plain_kernels(monkeypatch, handed):
    """K1 and the per-block kernel replaced by their plain versions (K1
    writing its Q|K|V into ``qkv_out``, the per-block kernel reading ``qkv``
    and writing dQ|dK|dV over it, as on the card), K2's GEMM and reduction
    by theirs; ``handed`` records the Q|K|V buffers each received."""

    def fake_launch(lib, xin, packed, nv, drop, *, n, t, nv_dev=None, qkv_out=None):
        handed.append(("k1", qkv_out))
        if qkv_out is not None:  # the Q|K|V the per-block kernel's plain version computes
            xc = xin[:nv * t].float()
            if drop.thr_emb:
                xc = xc * port._philox_mask(drop, philox.STREAM_EMB, nv * t, xin.shape[1],
                                            xin.device)
            qkv_out.zero_()[:nv * t] = _recomputed_qkv(xc.to(xin.dtype), packed, t, nv)
        return port.tiled_forward(xin, packed, nv, drop, n=n, t=t)

    def fake_core(lib, x, packed, g, nv, drop, *, n, t, nv_dev=None, qkv=None):
        handed.append(("k2", qkv))
        xc = x.clone()
        if drop.thr_emb:  # fp32: the kernel draws the stream-0 mask itself
            xc[:nv * t] *= port._philox_mask(drop, philox.STREAM_EMB, nv * t, x.shape[1],
                                             x.device)
        got = port.bwd_core_reference(xc, packed, g, t=t, nv=nv, drop=drop._replace(thr_emb=0),
                                      seed=SEED, keep_prob=KEEP, qkv=qkv)
        full = lambda v: torch.cat([v, v.new_zeros(n * t - v.shape[0], v.shape[1])])
        pad_a = lambda v: torch.nn.functional.pad(v, (0, packed.w_att.shape[1] - v.shape[1]))
        dqkv = full(got[0])
        if qkv is not None:
            qkv.copy_(dqkv)
            dqkv = qkv
        return dqkv, full(got[1]), full(got[2]), pad_a(got[3]), pad_a(got[4])

    def fake_gemm(a_, b, *, dx, rows, drop=port.Dropout(), splits=1, keep=None, valid=None):
        out = port.bwd_gemm_reference(a_, b, dx=dx, rows=rows, drop=drop, seed=SEED,
                                      emb_keep=KEEP)
        return out if dx else out[None]

    monkeypatch.setattr(port, "launch", fake_launch)
    monkeypatch.setattr(port, "launch_bwd_core", fake_core)
    monkeypatch.setattr(port, "_library", lambda: None)
    monkeypatch.setattr(port, "_library_bwd", lambda: None)
    monkeypatch.setattr(port, "bwd_gemm", fake_gemm)
    monkeypatch.setattr(port, "reduce_rows", lambda part: part.reshape(part.shape[0], -1).sum(0))
    _cpu_packing(monkeypatch)


@pytest.mark.parametrize("route", ["narrow", "tiled"])
def test_function_keeps_qkv_once_when_a_gradient_will_follow(monkeypatch, route):
    """fp32 with both Philox masks: with a gradient to follow the forward
    keeps its Q|K|V and the backward receives that buffer (K1's ``qkv_out``,
    or T1's output on the tiled route); a second backward over the retained
    graph computes it again and gives the first backward's gradients bit for
    bit; under ``no_grad``, or with no input needing a gradient, nothing is
    kept."""
    n, t, din, heads, head_dim, a, nv = 5, 20, 32, 4, 16, 48, 4
    x, ws, _, _, _, _, _ = _setup(torch.float32, n, t, din, heads, head_dim, a, nv)
    # the tiled route's counts (its plain versions count as its kernels do; K1 and the
    # per-block kernel are replaced by recorders of the buffers they are handed)
    counts = (port.tiled_forward.saved_qkv, port.tiled_bwd_core.saved_qkv,
              port.tiled_bwd_core.recomputed_qkv)
    handed = []
    _plain_kernels(monkeypatch, handed)
    monkeypatch.setattr(port, "_route", lambda packed, t_, din_, force_tiled=False,
                        instance=False: route)
    apply = lambda *ins: port.NewsEncoderFunction.apply(*ins, None, heads, torch.float32, nv,
                                                        KEEP, KEEP, SEED, None)
    before = [c.launches for c in counts]
    with torch.no_grad():
        apply(x.requires_grad_(True), *(w.requires_grad_(True) for w in ws))
    apply(x.detach(), *(w.detach() for w in ws))
    assert [c.launches for c in counts] == before
    assert all(h[1] is None for h in handed)
    handed.clear()
    ins = [v.detach().requires_grad_(True) for v in [x] + ws]
    out = apply(*ins)
    cot = torch.cos(torch.arange(out.numel(), dtype=torch.float32).reshape(out.shape) * 0.1)
    grads = []
    for _ in range(2):
        for v in ins:
            v.grad = None
        (out * cot).sum().backward(retain_graph=True)
        grads.append([v.grad.clone() for v in ins])
    if route == "tiled":
        assert [c.launches - b for c, b in zip(counts, before)] == [1, 1, 1] and not handed
    else:
        assert [c.launches for c in counts] == before
        (k1, buf), (k2a, first), (k2b, second) = handed
        assert (k1, k2a, k2b) == ("k1", "k2", "k2") and buf is not None
        assert first is buf and second is None
    for u, v in zip(*grads):
        assert torch.equal(u, v)
