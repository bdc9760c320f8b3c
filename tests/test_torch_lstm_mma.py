"""The host side of the bf16 LSTM kernels on the tensor cores
(``csrc/lstm_mma.cuh``: ``peer_context``, ``fused_encode`` and the serve
kernel in bf16): the packed weight layout and the block choosers, on the
CPU. The kernels
themselves are held against their plain versions on the card
(``tests/test_torch_kernel_cuda.py``)."""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import numpy as np
import pytest
import torch

from longterm360fov_tpu_torch.models.cell import LSTMParams, mm, round_to
from longterm360fov_tpu_torch.ops import fused_lstm

SMEM = 232448  # dynamic shared memory a Hopper block may use


def _layer(rng, k_in, hidden):
    w = torch.tensor(rng.normal(size=(k_in + hidden, 4 * hidden)).astype(np.float32) * 0.2)
    return LSTMParams(w, torch.tensor(rng.normal(size=4 * hidden).astype(np.float32)))


def _packed_product(z, packed, hidden):
    """The plain product over the packed layout: every packed element put
    back where ``_pack_index`` says it came from, then z (R, k rows) · W in
    f32."""
    k_rows = z.shape[1]
    w = torch.full((k_rows * 4 * hidden,), float("nan"), dtype=torch.bfloat16)
    idx = fused_lstm._pack_index(k_rows, hidden, torch.device("cpu"))
    assert packed.numel() == idx.numel() == k_rows * 4 * hidden
    assert torch.equal(idx.sort().values, torch.arange(idx.numel()))  # a permutation: every element once
    w[idx] = packed
    return z @ w.reshape(k_rows, 4 * hidden).float()


@pytest.mark.parametrize("hidden", [32, 128, 256])
def test_packed_product_is_the_bf16_gate_product(hidden):
    """Layer 0 ([x, h], d = 3 padded to one k16 step) and layer 1 ([h_0,
    h_1]) of a packed stack: the plain product over the packed layout equals
    [x, h] @ W with both operands rounded to bf16 and f32 sums."""
    rng = np.random.default_rng(hidden)
    d, rows = 3, 37
    ps = [_layer(rng, d, hidden), _layer(rng, hidden, hidden)]
    packed = fused_lstm.pack_weights(ps, d)
    assert packed.dtype == torch.bfloat16 and packed.numel() == (16 + hidden) * 4 * hidden + 2 * hidden * 4 * hidden
    x = torch.tensor(rng.normal(size=(rows, d)).astype(np.float32))
    h0, h1 = (torch.tensor(rng.uniform(-1, 1, size=(rows, hidden)).astype(np.float32)) for _ in range(2))
    bf = torch.bfloat16
    z0 = torch.cat([round_to(x, bf), torch.zeros(rows, 16 - d), round_to(h0, bf)], dim=1)
    n0 = (16 + hidden) * 4 * hidden
    got0 = _packed_product(z0, packed[:n0], hidden)
    torch.testing.assert_close(got0, mm(torch.cat([x, h0], dim=1), ps[0].w, bf), rtol=1e-6, atol=1e-6)
    z1 = torch.cat([round_to(h0, bf), round_to(h1, bf)], dim=1)
    got1 = _packed_product(z1, packed[n0:], hidden)
    torch.testing.assert_close(got1, mm(torch.cat([h0, h1], dim=1), ps[1].w, bf), rtol=1e-6, atol=1e-6)


def test_pack_puts_a_tiles_gates_together():
    """Packed n-tile j holds gate j % 4's columns of unit block j // 4: the
    first 16 bytes of lane (g, t) at k-step 0 are W[2t, 2t + 1, 2t + 8,
    2t + 9] at column g of gate i, then the same rows at column g of gate f."""
    hidden = 64
    w = torch.arange(19 * 4 * hidden, dtype=torch.float32).reshape(19, 4 * hidden)
    packed = fused_lstm.pack_weights([LSTMParams(w, torch.zeros(4 * hidden))], 3).float()
    for lane in (0, 5, 31):
        g, t = lane // 4, lane % 4
        rows = [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]
        wk = torch.cat([w[:3], torch.zeros(13, 4 * hidden), w[3:]])  # x padded to a k16 step
        want = [wk[k, g] for k in rows] + [wk[k, hidden + g] for k in rows]
        got = packed[lane * 8:(lane + 1) * 8]
        assert torch.equal(got, torch.stack(want).bfloat16().float())


@pytest.mark.parametrize("ctx_dim", [32, 64, 96, 128])
@pytest.mark.parametrize("k", [1, 3, 4, 7, 8])
def test_peer_tc_rows(ctx_dim, k):
    geo = fused_lstm.peer_tc_rows(ctx_dim, k, 3)
    rows = geo.rows_v * k
    tile = 16 * geo.mt
    assert rows <= geo.rp and geo.rp % tile == 0 and geo.rp - rows < tile  # whole viewers, padded to one tile
    assert rows + k > fused_lstm._tc_top(ctx_dim) or geo.rp - rows < tile  # no room for another viewer in the aim
    assert geo.w_res and geo.c_smem  # W and c stay in shared memory at the serving widths
    assert geo.smem == fused_lstm._tc_smem(True, geo.rp, rows, 3, ctx_dim, 1, True, True) <= SMEM
    tiles = geo.rp * ctx_dim // 512  # warp tiles of 512 (row, unit) pairs
    assert 1 <= geo.warps <= 16 and -(-tiles // geo.warps) == -(-tiles // 16)  # as few rounds of tiles as 16 warps
    assert geo.warps == 1 or -(-tiles // (geo.warps - 1)) > -(-tiles // geo.warps)  # and no warp more


def test_peer_tc_rows_at_the_serving_shape():
    """stacked-ss-crossuser-10s: K = 7 peers of C = 128: 9 viewers, 63 rows
    in 64, 16 warps, W and c resident, 256 bytes of room to spare; K = 8
    fits 7 viewers, not 8 (64 rows' f32 h would pass the limit by 256
    bytes)."""
    assert fused_lstm.peer_tc_rows(128, 7, 3) == fused_lstm.TcGeom(9, 64, 2, 16, True, True, 232192)
    assert fused_lstm.peer_tc_rows(128, 8, 3) == fused_lstm.TcGeom(7, 64, 2, 16, True, True, 228576)
    # a wide context: 16-row tiles, W streamed
    assert fused_lstm.peer_tc_rows(1024, 1, 3)[:6] == (16, 16, 1, 16, False, True)


@pytest.mark.parametrize("hidden,layers,want", [
    (128, 1, (0, 64, 2, 16, True, True)),     # the crossuser peer encoder: W resident
    (128, 2, (0, 64, 2, 16, False, True)),    # upper layers: W streamed
    (128, 3, (0, 64, 2, 16, False, True)),
    (32, 1, (0, 256, 2, 16, True, True)),
    (256, 2, (0, 32, 2, 16, False, True)),
    (1024, 3, (0, 16, 1, 16, False, False)),  # c in device memory
    (448, 8, (0, 16, 1, 14, False, False)),
])
def test_encode_tc_rows(hidden, layers, want):
    geo = fused_lstm.encode_tc_rows(hidden, layers, 3)
    assert geo[:6] == want
    assert geo.smem == fused_lstm._tc_smem(False, geo.rp, geo.rp, 3, hidden, layers, geo.w_res, geo.c_smem) <= SMEM


def test_tc_choosers_raise_for_shapes_they_do_not_take():
    with pytest.raises(ValueError, match="ctx_dim % 32"):
        fused_lstm.peer_tc_rows(48, 7, 3)
    with pytest.raises(ValueError, match="K = 257 peers"):
        fused_lstm.peer_tc_rows(32, 257, 3)
    with pytest.raises(ValueError, match="K = 0 peers"):
        fused_lstm.peer_tc_rows(128, 0, 3)
    with pytest.raises(ValueError, match="do not fit the bf16 peer context's block"):
        fused_lstm.peer_tc_rows(1024, 1, 7000)
    with pytest.raises(ValueError, match="hidden % 32"):
        fused_lstm.encode_tc_rows(48, 1, 3)
    with pytest.raises(ValueError, match="1..8 layers"):
        fused_lstm.encode_tc_rows(128, 9, 3)
    with pytest.raises(ValueError, match=r"\(ceil\(d / 16\)·16 \+ \(layers \+ 1\)·hidden \+ 8\)·32 bytes"):
        fused_lstm.encode_tc_rows(1024, 1, 5209)
    # every shape the f32 tier's blocks take at this width, the bf16 tier takes too
    for k in range(1, 65):
        try:
            fused_lstm.peer_tf32_rows(128, k, 3)
        except ValueError:
            continue
        fused_lstm.peer_tc_rows(128, k, 3)


@pytest.mark.parametrize("ctx_dim", [0, 64, 128])
def test_packed_decoder_layer0_is_the_bf16_gate_product(ctx_dim):
    """The serve decoder's layer 0 reads z's row [y padded to a k16 step |
    ctx | h_0] as one run: against pack_weights' layer 0 of its W ((d + C +
    H) x 4H), the plain product over the packed layout equals [y, ctx, h]
    @ W with the operands rounded to bf16 and f32 sums."""
    rng = np.random.default_rng(ctx_dim)
    d, hidden, rows = 3, 128, 29
    layer = _layer(rng, d + ctx_dim, hidden)
    packed = fused_lstm.pack_weights([layer], d)
    assert packed.numel() == (16 + ctx_dim + hidden) * 4 * hidden
    y = torch.tensor(rng.normal(size=(rows, d)).astype(np.float32))
    ctx = torch.tensor(rng.normal(size=(rows, ctx_dim)).astype(np.float32))
    h = torch.tensor(rng.uniform(-1, 1, size=(rows, hidden)).astype(np.float32))
    bf = torch.bfloat16
    z = torch.cat([round_to(y, bf), torch.zeros(rows, 16 - d), round_to(ctx, bf), round_to(h, bf)], dim=1)
    got = _packed_product(z, packed, hidden)
    torch.testing.assert_close(got, mm(torch.cat([y, ctx, h], dim=1), layer.w, bf), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("preset,layers,ctx_dim,step_ctx,want", [
    ("seq2seq-tf-30", 1, 0, False, (64, 2, 16, True, True, 218624)),            # W resident: 144 KB a phase
    ("stacked-ss-crossuser", 2, 128, False, (64, 2, 16, False, True, 136704)),  # W from L2
    ("stacked-ss-crossuser-10s", 2, 128, True, (64, 2, 16, False, True, 169472)),  # and ctx_t+1 in f32
    ("video-fusion", 2, 64, False, (64, 2, 16, False, True, 128512)),
])
def test_serve_tc_rows_at_the_preset_shapes(preset, layers, ctx_dim, step_ctx, want):
    """Every serving preset's shape is taken in 64-row blocks of 16 warps:
    W resident where the larger phase's packed W fits beside the state
    (seq2seq-tf-30), else read from L2, c in shared memory."""
    from longterm360fov_tpu_torch.config import get_preset
    m = get_preset(preset).model
    assert (m.layers, m.ctx_dim, bool(m.peer_align)) == (layers, ctx_dim, step_ctx)
    geo = fused_lstm.serve_tc_rows(m.hidden, m.layers, m.d, m.ctx_dim, step_ctx)
    assert geo[1:7] == want
    assert geo.smem == fused_lstm._serve_smem(geo.rp, m.d, m.ctx_dim, m.hidden, m.layers, geo.w_res, geo.c_smem,
                                              step_ctx) <= SMEM


@pytest.mark.parametrize("layers", range(1, 9))
@pytest.mark.parametrize("ctx_dim", [0, 64, 128])
def test_serve_tc_rows_takes_every_depth(layers, ctx_dim):
    """L = 1..8 at C = 0, 64, 128 in both tiers, T_in and T_out anything:
    always 64 rows; 16-row blocks (MT = 1) where forced."""
    for step in (False, True) if ctx_dim else (False,):
        geo = fused_lstm.serve_tc_rows(128, layers, 3, ctx_dim, step)
        assert (geo.rp, geo.mt, geo.warps) == (64, 2, 16) and geo.smem <= SMEM
        small = fused_lstm.serve_tc_rows(128, layers, 3, ctx_dim, step, rows=16)
        assert (small.rp, small.mt, small.warps) == (16, 1, 4) and small.smem <= SMEM


def test_serve_tc_rows_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="hidden % 32 == 0, got 48"):
        fused_lstm.serve_tc_rows(48, 1, 3)
    with pytest.raises(ValueError, match="1..8 layers, got 9"):
        fused_lstm.serve_tc_rows(128, 9, 3)
    with pytest.raises(ValueError, match="ctx_dim % 16 == 0, got 8"):
        fused_lstm.serve_tc_rows(128, 1, 3, 8)
    with pytest.raises(ValueError, match="blocks of 16, 32, 64, 128 or 256 rows, got 48"):
        fused_lstm.serve_tc_rows(128, 1, 3, rows=48)
    with pytest.raises(ValueError, match=r"block of 16 rows needs \d+ bytes of shared memory"):
        fused_lstm.serve_tc_rows(1024, 8, 3, 128, True)


# ------------------------------------------------------------------ the f32 tier
# The f32 serve kernel and peer context on three-pass TF32 (lstm_mma.cuh's
# server and encoder with Tf32Mma): W packed by pack_weights_tf32 in mma
# m16n8k8's TF32 B-fragment order, z in f32 padded to whole k8 steps.


def _packed_product_tf32(z, packed, hidden):
    """The plain f32 product over the TF32 packed layout: every packed
    element put back where ``_pack_index_tf32`` says it came from, then z
    (R, k rows) · W."""
    k_rows = z.shape[1]
    w = torch.full((k_rows * 4 * hidden,), float("nan"))
    idx = fused_lstm._pack_index_tf32(k_rows, hidden, torch.device("cpu"))
    assert packed.numel() == idx.numel() == k_rows * 4 * hidden
    assert torch.equal(idx.sort().values, torch.arange(idx.numel()))  # a permutation: every element once
    w[idx] = packed
    return z.double() @ w.reshape(k_rows, 4 * hidden).double()


@pytest.mark.parametrize("hidden", [32, 128, 256])
def test_packed_tf32_layer_is_w_and_its_product_the_f32_gate_product(hidden):
    """Layer 0 ([x, h], d = 3 padded to one k8 step) and layer 1 ([h_0,
    h_1]) of a stack packed by pack_weights_tf32: read back through the
    fragment map, each layer is W itself (its x rows padded with zeros), and
    the product over the packed layout is [x, h] @ W."""
    rng = np.random.default_rng(hidden)
    d, rows = 3, 37
    ps = [_layer(rng, d, hidden), _layer(rng, hidden, hidden)]
    packed = fused_lstm.pack_weights_tf32(ps, d)
    n0 = (8 + hidden) * 4 * hidden
    assert packed.dtype == torch.float32 and packed.numel() == n0 + 2 * hidden * 4 * hidden
    back = torch.empty(n0)
    back[fused_lstm._pack_index_tf32(8 + hidden, hidden, torch.device("cpu"))] = packed[:n0]
    want = torch.cat([ps[0].w[:d], torch.zeros(8 - d, 4 * hidden), ps[0].w[d:]])
    assert torch.equal(back.reshape(8 + hidden, 4 * hidden), want)
    x = torch.tensor(rng.normal(size=(rows, d)).astype(np.float32))
    h0, h1 = (torch.tensor(rng.uniform(-1, 1, size=(rows, hidden)).astype(np.float32)) for _ in range(2))
    z0 = torch.cat([x, torch.zeros(rows, 8 - d), h0], dim=1)
    ref0 = torch.cat([x, h0], dim=1).double() @ ps[0].w.double()
    torch.testing.assert_close(_packed_product_tf32(z0, packed[:n0], hidden), ref0, rtol=1e-12, atol=1e-12)
    ref1 = torch.cat([h0, h1], dim=1).double() @ ps[1].w.double()
    got1 = _packed_product_tf32(torch.cat([h0, h1], dim=1), packed[n0:], hidden)
    torch.testing.assert_close(got1, ref1, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("ctx_dim", [0, 12, 64, 128])
def test_packed_tf32_decoder_layer0_is_the_f32_gate_product(ctx_dim):
    """The f32 serve decoder's layer 0 reads z's row [y padded to a k8
    step | ctx padded to a k8 step | h_0] as one run: against
    pack_weights_tf32's layer 0 of its W ((d + C + H) x 4H), the product
    over the packed layout equals [y, ctx, h] @ W (C = 12: four zero rows
    after the context)."""
    rng = np.random.default_rng(ctx_dim)
    d, hidden, rows = 3, 128, 29
    cp = -(-ctx_dim // 8) * 8
    layer = _layer(rng, d + ctx_dim, hidden)
    packed = fused_lstm.pack_weights_tf32([layer], d, ctx_dim)
    assert packed.numel() == (8 + cp + hidden) * 4 * hidden
    y = torch.tensor(rng.normal(size=(rows, d)).astype(np.float32))
    ctx = torch.tensor(rng.normal(size=(rows, ctx_dim)).astype(np.float32))
    h = torch.tensor(rng.uniform(-1, 1, size=(rows, hidden)).astype(np.float32))
    z = torch.cat([y, torch.zeros(rows, 8 - d), ctx, torch.zeros(rows, cp - ctx_dim), h], dim=1)
    got = _packed_product_tf32(z, packed, hidden)
    torch.testing.assert_close(got, torch.cat([y, ctx, h], dim=1).double() @ layer.w.double(), rtol=1e-12, atol=1e-12)


def test_pack_tf32_puts_a_tiles_gates_together():
    """Per k8 step and pair of n-tiles, lane (g, t)'s 16 bytes are W[t] and
    W[t + 4] at column g of gate i (n-tile 0 of unit block 0), then the same
    rows at column g of gate f (n-tile 1)."""
    hidden = 64
    w = torch.arange(19 * 4 * hidden, dtype=torch.float32).reshape(19, 4 * hidden)
    packed = fused_lstm.pack_weights_tf32([LSTMParams(w, torch.zeros(4 * hidden))], 3)
    wk = torch.cat([w[:3], torch.zeros(5, 4 * hidden), w[3:]])  # x padded to a k8 step
    for lane in (0, 5, 31):
        g, t = lane // 4, lane % 4
        want = [wk[t, g], wk[t + 4, g], wk[t, hidden + g], wk[t + 4, hidden + g]]
        assert torch.equal(packed[lane * 4:(lane + 1) * 4], torch.stack(want))
    # pair 1 of k-step 0: unit block 0's gates g and o; k-step 1 starts H / 4 pairs x 32 lanes later
    assert torch.equal(packed[32 * 4:32 * 4 + 4], torch.stack([wk[0, 2 * hidden], wk[4, 2 * hidden],
                                                                  wk[0, 3 * hidden], wk[4, 3 * hidden]]))
    k1 = hidden // 4 * 32 * 4
    assert torch.equal(packed[k1:k1 + 2], torch.stack([wk[8, 0], wk[12, 0]]))


def _tf32(x):
    """cvt.rna.tf32.f32: x rounded to 10 mantissa bits, to nearest, ties
    away from zero (on the magnitude's bits), as f32."""
    b = np.asarray(x, np.float32).view(np.int32)
    return ((b + np.int32(0x1000)) & np.int32(-0x2000)).view(np.float32)


def _truncate_tf32(x):
    """x as mma reads an f32 register as a TF32 operand: its 13 low
    mantissa bits dropped."""
    return (np.asarray(x, np.float32).view(np.int32) & np.int32(-0x2000)).view(np.float32)


def _split(x):
    """lstm_mma.cuh's split_fast as the tensor cores read it: hi = x with
    its 13 low mantissa bits cleared, lo = x - hi (exact in f32), read as
    TF32 (its low bits dropped)."""
    hi = _truncate_tf32(x)
    return hi, _truncate_tf32((x - hi).astype(np.float32))


def _toward_zero_f32(x):
    """f64 values rounded toward zero to f32."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def _three_pass(a, b, chunk):
    """The f32 tier's product as the tensor cores compute it: a (R, K) and
    b (K, N) split into TF32 hi and lo (:func:`_split`); per k8 step the
    three mma a_lo·b_hi, a_hi·b_lo, a_hi·b_hi (a_lo·b_lo dropped), each
    adding the exact sum of its 8 products to the accumulator and rounding
    toward zero; each chunk of ``chunk`` k8 steps from fresh accumulators,
    added to the f32 sum with rounding to nearest."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for c0 in range(0, a.shape[1], 8 * chunk):
        acc = np.zeros_like(total)
        for k0 in range(c0, min(c0 + 8 * chunk, a.shape[1]), 8):
            s = slice(k0, k0 + 8)
            for x, y in ((al, bh), (ah, bl), (ah, bh)):
                acc = _toward_zero_f32(acc.astype(np.float64) + x[:, s].astype(np.float64) @ y[s].astype(np.float64))
        total = (total + acc).astype(np.float32)
    return total


def test_split_keeps_21_bits_and_hi_is_tf32():
    """hi is a TF32 value and x - hi is exact; hi + tf32(lo) is within
    2^-21 of x, relative."""
    x = np.random.default_rng(0).normal(size=100000).astype(np.float32) * 10.0 ** np.arange(-5, 5).repeat(10000)
    hi, lo = _split(x)
    assert np.array_equal(hi, _truncate_tf32(hi)) and np.array_equal(lo, _truncate_tf32(lo))
    assert np.array_equal((x - hi).astype(np.float64), x.astype(np.float64) - hi.astype(np.float64))
    assert (np.abs(hi.astype(np.float64) + lo - x) <= 2.0 ** -21 * np.abs(x)).all()


@pytest.mark.parametrize("preset,layer,chunk", [("stacked-ss-crossuser-10s", "decoder 0", 8),
                                                ("stacked-ss-crossuser-10s", "peer", 4),
                                                ("seq2seq-tf-30", "encoder 0", 4)])
def test_three_pass_tf32_product_lands_within_its_bound(preset, layer, chunk):
    """The emulated three-pass product (:func:`_split`, a_lo·b_lo dropped,
    truncating mma sums in chunks of 4 k8 steps, TF32_CHUNK, or 8 in the
    lockstep serve kernel, TF32_CHUNK_STEP_CTX) of a preset layer's
    [y | ctx | h] or [x | h] rows with its W stays within its stated bound
    of the f64 product, of Σ_k |a_k|·|b_k|: 2^-19 for the split and the
    dropped term, 3·chunk·2^-23 for a chunk's truncating mma, 2^-24 for
    each chunk's add. A one-pass product (a_hi·b_hi alone) does not."""
    from longterm360fov_tpu_torch.config import get_preset
    m = get_preset(preset).model
    rng = np.random.default_rng(7)
    k_in = {"decoder 0": m.d + m.ctx_dim, "peer": m.d, "encoder 0": m.d}[layer]
    hidden = m.ctx_dim if layer == "peer" else m.hidden
    w = _layer(rng, k_in, hidden).w.numpy()
    z = np.concatenate([rng.normal(size=(64, m.d)), rng.normal(size=(64, k_in - m.d)),
                        rng.uniform(-1, 1, size=(64, hidden))], axis=1).astype(np.float32)
    exact = z.astype(np.float64) @ w.astype(np.float64)
    scale = np.abs(z).astype(np.float64) @ np.abs(w).astype(np.float64)
    bound = 2.0 ** -19 + 3 * chunk * 2.0 ** -23 + -(-z.shape[1] // (8 * chunk)) * 2.0 ** -24
    got = _three_pass(z, w, chunk)
    assert (np.abs(got - exact) <= bound * scale).all()
    one_pass = _truncate_tf32(z).astype(np.float64) @ _truncate_tf32(w).astype(np.float64)
    assert (np.abs(one_pass - exact) > bound * scale).any()


@pytest.mark.parametrize("preset,want", [
    ("seq2seq-tf-30", (64, 2, 16, False, True, 104960)),
    ("stacked-ss-crossuser", (64, 2, 16, False, True, 203264)),
    ("stacked-ss-crossuser-10s", (64, 4, 8, False, False, 170496)),  # c in device memory
    ("video-fusion", (64, 2, 16, False, True, 186880)),
])
def test_serve_tf32_rows_at_the_preset_shapes(preset, want):
    """Every serving preset's shape in the f32 tier: 64-row blocks, W from
    L2; 16 warps of 32 x 8 tiles, but the lockstep serve kernel's 8 warps
    of 64 x 8 tiles; c in shared memory but in the lockstep tier (z, the
    staging and ctx_t+1 in f32 leave it no room)."""
    from longterm360fov_tpu_torch.config import get_preset
    m = get_preset(preset).model
    step = bool(m.peer_align)
    geo = fused_lstm.serve_tf32_rows(m.hidden, m.layers, m.d, m.ctx_dim, step)
    assert geo[1:7] == want
    assert geo.smem == fused_lstm._serve_smem(geo.rp, m.d, m.ctx_dim, m.hidden, m.layers, False, geo.c_smem, step,
                                              f32=True) <= SMEM
    assert not fused_lstm._serve_smem(64, m.d, m.ctx_dim, m.hidden, m.layers, False, True, step, f32=True) <= SMEM \
        if step else geo.c_smem


@pytest.mark.parametrize("layers", range(1, 9))
@pytest.mark.parametrize("ctx_dim", [0, 12, 64, 128])
def test_serve_tf32_rows_takes_every_depth(layers, ctx_dim):
    """L = 1..8 at C = 0, 12, 64, 128, in both context tiers: 64-row blocks
    where z and the staging fit with c in device memory, else 32-row ones,
    as also where asked for, within a block's shared memory; 16 warps of
    32 x 8 tiles, the lockstep serve kernel 8 warps of 64 x 8 (32 x 16 in
    32 rows)."""
    for step in (False, True) if ctx_dim else (False,):
        geo = fused_lstm.serve_tf32_rows(128, layers, 3, ctx_dim, step)
        rp = 64 if fused_lstm._serve_smem(64, 3, ctx_dim, 128, layers, False, False, step, f32=True) <= SMEM else 32
        want = (rp, rp // 16, 8) if step else (rp, 2, 16)
        assert (geo.rp, geo.mt, geo.warps, geo.w_res) == (*want, False) and geo.smem <= SMEM
        small = fused_lstm.serve_tf32_rows(128, layers, 3, ctx_dim, step, rows=32)
        assert (small.rp, small.mt, small.warps) == (32, 2, 8 if step else 16) and small.smem <= SMEM
    narrow = fused_lstm.serve_tf32_rows(32, layers, 3, ctx_dim)  # more rows a block: up to 256 at H = 32
    assert narrow.rp in (256, 128, 64) and (narrow.mt, narrow.warps) == (2, 16)
    assert layers > 1 or narrow.rp == 256


def test_serve_tf32_rows_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="hidden % 32 == 0, got 48"):
        fused_lstm.serve_tf32_rows(48, 1, 3)
    with pytest.raises(ValueError, match="1..8 layers, got 9"):
        fused_lstm.serve_tf32_rows(128, 9, 3)
    with pytest.raises(ValueError, match="ctx_dim % 4 == 0, got 6"):
        fused_lstm.serve_tf32_rows(128, 1, 3, 6)
    with pytest.raises(ValueError, match="1..4 coordinates a token, got d=5"):
        fused_lstm.serve_tf32_rows(128, 1, 5)
    with pytest.raises(ValueError, match="blocks of 32, 64, 128 or 256 rows, got 16"):
        fused_lstm.serve_tf32_rows(128, 1, 3, rows=16)
    with pytest.raises(ValueError, match=r"d=3, ctx_dim=128, hidden=1024, layers=2: .* block of 32 rows needs "
                                         r"\d+ bytes of shared memory"):
        fused_lstm.serve_tf32_rows(1024, 2, 3, 128, True)


@pytest.mark.parametrize("ctx_dim", [32, 64, 96, 128])
@pytest.mark.parametrize("k", range(1, 9))
def test_peer_tf32_rows(ctx_dim, k):
    """All K peers of whole viewers in blocks of whole 32-row tiles (up to
    256 rows at C = 32), no room for another viewer, W streamed, c in shared
    memory, as few rounds of 32 x 8 tiles as 16 warps take; one 32-row
    tile where asked for."""
    for rows in (0, 32):
        geo = fused_lstm.peer_tf32_rows(ctx_dim, k, 3, rows=rows)
        real = geo.rows_v * k
        assert geo.rp % 32 == 0 and geo.mt == 2 and real <= geo.rp < real + 32
        top = 32 if rows else fused_lstm._tc_top(ctx_dim) // 32 * 32
        assert geo.rp <= top and real + k > top  # the most whole viewers the aim takes
        assert not geo.w_res and geo.c_smem
        assert geo.smem == fused_lstm._tc_smem(True, geo.rp, real, 3, ctx_dim, 1, False, True, f32=True) <= SMEM
        tiles = geo.rp * ctx_dim // 256
        assert 1 <= geo.warps <= 16 and -(-tiles // geo.warps) == -(-tiles // 16)
        assert geo.warps == 1 or -(-tiles // (geo.warps - 1)) > -(-tiles // geo.warps)


@pytest.mark.parametrize("ctx_dim", [32, 64, 96, 128])
@pytest.mark.parametrize("k", [9, 16, 31, 33, 63, 64, 65, 100, 128, 129, 200, 255, 256])
def test_peer_tf32_rows_takes_every_k_the_bf16_tier_takes(ctx_dim, k):
    """Past 8 peers: whole viewers up to _tc_top's aim, then one viewer in
    as many whole 32-row tiles as its K rows need (up to 256); c, then the
    staging of h, in device memory only where they do not fit beside z (at
    C = 128: c from 129 rows, the staging too from 208); the bytes
    lstm_mma::smem_bytes counts, within a block's shared memory."""
    fused_lstm.peer_tc_rows(ctx_dim, k, 3)
    geo = fused_lstm.peer_tf32_rows(ctx_dim, k, 3)
    real = geo.rows_v * k
    top = fused_lstm._tc_top(ctx_dim) // 32 * 32
    assert geo.rp % 32 == 0 and real <= geo.rp < real + 32 and geo.mt == 2 and not geo.w_res
    assert geo.rows_v == max(1, top // k) and geo.rp <= max(top, -(-k // 32) * 32) <= 256
    assert geo.smem == fused_lstm._tc_smem(True, geo.rp, real, 3, ctx_dim, 1, False, geo.c_smem, f32=True,
                                           h_smem=geo.h_smem) <= SMEM
    layouts = fused_lstm._TF32_PEER_LAYOUTS
    for c_smem, h_smem in layouts[:layouts.index((geo.c_smem, geo.h_smem))]:  # every layout preferred is too big
        assert fused_lstm._tc_smem(True, geo.rp, real, 3, ctx_dim, 1, False, c_smem, f32=True, h_smem=h_smem) > SMEM
    assert geo.h_smem or (ctx_dim, geo.c_smem) == (128, False)
    tiles = geo.rp * ctx_dim // 256
    assert 1 <= geo.warps <= 16 and -(-tiles // geo.warps) == -(-tiles // 16)


def test_peer_tf32_rows_at_the_serving_shape():
    """stacked-ss-crossuser-10s: K = 7 peers of C = 128, 9 viewers in 64
    rows, 16 warps of two 32 x 8 tiles each, 101,120 bytes."""
    assert fused_lstm.peer_tf32_rows(128, 7, 3) == fused_lstm.TcGeom(9, 64, 2, 16, False, True, 101120)


def test_peer_tf32_rows_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="ctx_dim 32, 64, 96 or 128, got 160"):
        fused_lstm.peer_tf32_rows(160, 7, 3)
    with pytest.raises(ValueError, match="ctx_dim 32, 64, 96 or 128, got 48"):
        fused_lstm.peer_tf32_rows(48, 7, 3)
    for k in (0, 257, 1000):
        with pytest.raises(ValueError, match=f"K = {k} peers"):
            fused_lstm.peer_tf32_rows(128, k, 3)
    with pytest.raises(ValueError, match="or 32 rows, got 16"):
        fused_lstm.peer_tf32_rows(128, 7, 3, rows=16)
    with pytest.raises(ValueError, match=r"d=20000, ctx_dim=128: one viewer's K = 7 peers need \d+ bytes"):
        fused_lstm.peer_tf32_rows(128, 7, 20000)


@pytest.mark.parametrize("hidden,layers,want", [
    (128, 1, (0, 64, 2, 16, False, True, 103424)),   # the crossuser peer encoder (C = 128), 4·B rows
    (64, 1, (0, 128, 2, 16, False, True, 108544)),   # a peer encoder of C = 64: 128 rows, as peer_tf32_rows aims
    (128, 2, (0, 64, 2, 16, False, True, 168960)),
    (32, 1, (0, 256, 2, 16, False, True, 118784)),
    (128, 4, (0, 64, 2, 16, False, False, 168960)),  # c in device memory: rows come first
    (128, 8, (0, 32, 2, 16, False, False, 150016)),
])
def test_encode_tf32_rows(hidden, layers, want):
    """The f32 encoder's block (row 4 on three-pass TF32, the f32 peer
    context's body): the most rows up to _tc_top's aim, c in shared memory
    where it fits, W streamed; 16 warps of 32 x 8 tiles; within a block's
    shared memory, the bytes lstm_mma::smem_bytes counts."""
    geo = fused_lstm.encode_tf32_rows(hidden, layers, 3)
    assert geo == fused_lstm.TcGeom(*want)
    assert geo.smem == fused_lstm._tc_smem(False, geo.rp, geo.rp, 3, hidden, layers, False, geo.c_smem,
                                           f32=True) <= SMEM
    tiles = geo.rp * hidden // 256
    assert -(-tiles // geo.warps) == -(-tiles // 16)


def test_encode_tf32_rows_at_the_serving_shape():
    """stacked-ss-crossuser serves its K = 4 peers through fused_encode:
    L = 1, H = ctx_dim = 128, d = 3, in the f32 peer context's blocks of 64
    rows (its 9 viewers' 63 rows, padded) and 16 warps."""
    from longterm360fov_tpu_torch.config import get_preset
    m = get_preset("stacked-ss-crossuser").model
    geo = fused_lstm.encode_tf32_rows(m.ctx_dim, 1, m.d)
    peer = fused_lstm.peer_tf32_rows(m.ctx_dim, 7, m.d)
    assert (geo.rp, geo.mt, geo.warps, geo.w_res, geo.c_smem) == (peer.rp, peer.mt, peer.warps, False, True)


def test_encode_tf32_rows_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="f32 encoder needs hidden % 32 == 0, got 48"):
        fused_lstm.encode_tf32_rows(48, 1, 3)
    with pytest.raises(ValueError, match="f32 encoder takes 1..8 layers, got 9"):
        fused_lstm.encode_tf32_rows(128, 9, 3)
    with pytest.raises(ValueError, match="d >= 1 coordinates a token, got d=0"):
        fused_lstm.encode_tf32_rows(128, 1, 0)
    with pytest.raises(ValueError, match=r"d=3, hidden=1024, layers=3: the f32 encoder's block of 32 rows .* "
                                         r"\d+ bytes of shared memory with c in device memory"):
        fused_lstm.encode_tf32_rows(1024, 3, 3)
