"""The host side of the bf16 LSTM kernels on the tensor cores
(``csrc/lstm_mma.cuh``: ``peer_context``, ``fused_encode`` and the serve
kernel in bf16): the packed weight layout and the block choosers, on the
CPU. The kernels
themselves are held against their plain versions on the card
(``tests/test_torch_kernel_cuda.py``)."""

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
    # every shape the f32 tier's rows take at this width, the bf16 tier takes too
    for k in range(1, 65):
        try:
            fused_lstm.peer_rows(128, k)
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
    assert geo[1:] == want
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
