"""The host side of the training recurrences on the tensor cores: the
scheduled-sampling decoder's backward (``csrc/lstm_common.cuh``
ss_bwd_kernel: ``ops.lstm_ss.pack_bwd_weights``, ``bwd_block``), its
teacher-forced mode, row 5's backward (``ops.lstm_train.bwd_block``,
``bwd_split``), and the lockstep peer forward (``csrc/lstm_align.cu`` on ``lstm_mma.cuh``'s encoder:
``ops.lstm_align.peer_fwd_block``), on the CPU. The packed Wᵀ is read back
as mma.sync's B fragments, and its products, emulated as the tensor cores
compute them, held against ``dgates · Wᵀ``; the kernels themselves are held
against their plain versions on the card (``tests/test_torch_kernel_cuda.py``)."""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import numpy as np
import pytest
import torch

from longterm360fov_tpu_torch.config import get_preset
from longterm360fov_tpu_torch.models.cell import LSTMParams, mm, round_to
from longterm360fov_tpu_torch.ops import fused_lstm, lstm_align, lstm_ss, lstm_train

SMEM = 232448  # dynamic shared memory a Hopper block may use
BF = torch.bfloat16


def _stack(rng, d_in0, layers, hidden):
    return [LSTMParams(torch.tensor(rng.normal(size=((d_in0 if l == 0 else hidden) + hidden, 4 * hidden))
                                    .astype(np.float32) * 0.2),
                       torch.zeros(4 * hidden)) for l in range(layers)]


def _fragments(packed, n_rows, hidden, f32):
    """B (4H, n_rows) read back from one layer's packed stream as the kernel
    reads it: per n-tile, k-pair and lane (g, t), 16 bytes, the mma B
    fragments of two k-steps. m16n8k8 TF32: b0 = B[t][g], b1 = B[t + 4][g];
    m16n8k16 bf16: b0 = B[2t, 2t + 1][g], b1 = B[2t + 8, 2t + 9][g]."""
    ks, ev = (8, 4) if f32 else (16, 8)
    kpairs = 4 * hidden // (2 * ks)
    assert packed.numel() == n_rows // 8 * kpairs * 32 * ev
    piece = packed.reshape(n_rows // 8, kpairs, 32, ev)
    b = torch.full((4 * hidden, n_rows), float("nan"), dtype=packed.dtype)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        n = 8 * torch.arange(n_rows // 8) + g
        for kp in range(kpairs):
            for half in range(2):  # the pair's two k-steps
                k0 = ks * (2 * kp + half)
                v = piece[:, kp, lane, half * ev // 2:(half + 1) * ev // 2]
                ks_of = [t, t + 4] if f32 else [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]
                for j, k in enumerate(ks_of):
                    b[k0 + k, n] = v[:, j]
    return b


def _truncate_tf32(x):
    return (np.asarray(x, np.float32).view(np.int32) & np.int32(-0x2000)).view(np.float32)


def _toward_zero_f32(x):
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def _three_pass(a, b, chunk=4):
    """The f32 tier's product as ss_bwd_kernel's ssb_product computes it:
    split_fast (hi: 13 low mantissa bits cleared; lo = x - hi read as TF32),
    a_lo·b_hi, a_hi·b_lo, a_hi·b_hi per k8 step into truncating
    accumulators, chunks of 4 k8 steps added to the f32 sum."""
    ah = _truncate_tf32(a)
    al = _truncate_tf32((a - ah).astype(np.float32))
    bh = _truncate_tf32(b)
    bl = _truncate_tf32((b - bh).astype(np.float32))
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for c0 in range(0, a.shape[1], 8 * chunk):
        acc = np.zeros_like(total)
        for k0 in range(c0, c0 + 8 * chunk, 8):
            s = slice(k0, k0 + 8)
            for x, y in ((al, bh), (ah, bl), (ah, bh)):
                acc = _toward_zero_f32(acc.astype(np.float64) + x[:, s].astype(np.float64) @ y[s].astype(np.float64))
        total = (total + acc).astype(np.float32)
    return total


@pytest.mark.parametrize("cd", [torch.float32, BF])
@pytest.mark.parametrize("layers,ctx_dim,hidden", [(2, 128, 128), (2, 64, 128), (1, 0, 128), (3, 32, 64)])
def test_packed_bwd_weights_are_w_transposed_in_product_order(layers, ctx_dim, hidden, cd):
    """Read back as B fragments, each layer's packed stream is Wᵀ with its
    columns in the product's order: layer 0 [dh (W[D+C:]) | dctx
    (W[D:D+C])], layer l > 0 [dh (W[H:]) | the layer below's h (W[:H])], in
    the tier's type (dx, from W[:D], is not in the stream: the warps'
    ``mma.sync`` partials over their own gate columns compute it)."""
    rng = np.random.default_rng(layers + ctx_dim)
    d = 3
    ps = _stack(rng, d + ctx_dim, layers, hidden)
    packed = lstm_ss.pack_bwd_weights(ps, d, ctx_dim, cd)
    assert len(packed) == layers
    for l, (p, pk) in enumerate(zip(ps, packed)):
        assert pk.dtype == cd
        n_rows = hidden + ctx_dim if l == 0 else 2 * hidden
        b = _fragments(pk, n_rows, hidden, cd == torch.float32).float()
        w = round_to(p.w, cd)
        want = torch.cat([w[d + ctx_dim:], w[d:d + ctx_dim]] if l == 0 else [w[hidden:], w[:hidden]])
        assert torch.equal(b, want.t())


@pytest.mark.parametrize("cd", [torch.float32, BF])
@pytest.mark.parametrize("preset", ["stacked-ss-crossuser-10s", "video-fusion"])
def test_packed_bwd_product_is_dgates_times_w_transposed(preset, cd):
    """A preset decoder's layer 0 and layer 1: the product over the packed
    stream, emulated as the tensor cores compute it (three-pass TF32 in
    chunks of 4 k8 steps; bf16 operands with f32 sums), equals the plain
    version's dgates · Wᵀ (``mm``) but for dx split into its columns: within
    the three-pass bound of Σ|dg|·|W| in f32 (2^-19 + 12·2^-23 + 16·2^-24),
    and 1e-5 relative in bf16 (another order of f32 sums)."""
    m = get_preset(preset).model
    rng = np.random.default_rng(3)
    d, hidden, ctx_dim = m.d, m.hidden, m.ctx_dim
    ps = _stack(rng, d + ctx_dim, m.layers, hidden)
    packed = lstm_ss.pack_bwd_weights(ps, d, ctx_dim, cd)
    dg = torch.tensor(rng.normal(size=(37, 4 * hidden)).astype(np.float32) * 0.1)
    for l in range(m.layers):
        n_rows = hidden + ctx_dim if l == 0 else 2 * hidden
        b = _fragments(packed[l], n_rows, hidden, cd == torch.float32).float()
        ref = mm(dg, ps[l].w.t(), cd)  # the plain version's dz = [input grad | dh]
        d_in = d + ctx_dim if l == 0 else hidden
        want = torch.cat([ref[:, d_in:], ref[:, d:d_in]] if l == 0 else [ref[:, d_in:], ref[:, :d_in]], dim=1)
        if cd == torch.float32:
            got = _three_pass(dg.numpy(), b.numpy())[:, :want.shape[1]]
            scale = np.abs(dg.numpy()).astype(np.float64) @ np.abs(b.numpy()).astype(np.float64)
            bound = 2.0 ** -19 + 12 * 2.0 ** -23 + 16 * 2.0 ** -24
            assert (np.abs(got - want.numpy()) <= bound * scale[:, :want.shape[1]] + 1e-30).all()
        else:
            got = (round_to(dg, BF).double() @ b.double())[:, :want.shape[1]]
            torch.testing.assert_close(got.float(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cd", [torch.float32, BF])
@pytest.mark.parametrize("preset,step_ctx", [("stacked-ss-crossuser", False), ("stacked-ss-crossuser-10s", True),
                                             ("video-fusion", False)])
def test_bwd_block_at_the_training_shapes(preset, step_ctx, cd):
    """Every preset that trains the scheduled-sampling decoder: 32 rows in
    16 warps (one a unit block of 8), W read 3 k-pairs ahead through rings
    of 4, one A buffer of dgates in either tier; within a block's shared
    memory, the smem the kernel's ssb_smem_bytes counts."""
    m = get_preset(preset).model
    geo = lstm_ss.bwd_block(m.hidden, m.layers, m.d, m.ctx_dim, cd, step_ctx)
    assert (geo.rows, geo.warps, geo.stages) == (32, 16, 4) and geo.smem <= SMEM
    e = 4 if cd == torch.float32 else 2
    a_buf = 32 * (4 * m.hidden + 16 // e) * e
    assert geo.smem == (a_buf + 8 * m.layers * 32 * m.hidden + (0 if step_ctx else 4 * 32 * m.ctx_dim)
                        + 4 * 32 * 8 * (1 + 16) + 16 * 1024 * 4)


@pytest.mark.parametrize("cd", [torch.float32, BF])
@pytest.mark.parametrize("step_ctx", [False, True])
@pytest.mark.parametrize("layers", range(1, 9))
def test_bwd_block_takes_the_first_layout_that_fits(layers, step_ctx, cd):
    """Deeper stacks keep every layer's carried dh and dc: 32 rows with W
    rings of 4 k-pairs where they fit, else of 2 (f32 at 3 layers, bf16 at
    4); past that 16 rows (one m16 tile) with a ring of 2, which every depth
    up to 8 at hidden 128 fits."""
    f32 = cd == torch.float32
    fits = [s for s in lstm_ss._BWD_STAGES if lstm_ss._bwd_smem(128, layers, 128, step_ctx, s, f32) <= SMEM]
    assert fits[:1] == ([4] if layers <= 2 + (not f32) else [2] if layers <= 3 + (not f32) else [])
    geo = lstm_ss.bwd_block(128, layers, 3, 128, cd, step_ctx)
    if fits:
        assert (geo.rows, geo.warps, geo.stages) == (32, 16, fits[0])
        assert geo.smem == lstm_ss._bwd_smem(128, layers, 128, step_ctx, geo.stages, f32) <= SMEM
    else:
        assert (geo.rows, geo.warps, geo.stages) == (16, 16, 2)
        assert geo.smem == lstm_ss._bwd_smem(128, layers, 128, step_ctx, 2, f32, rows=16) <= SMEM


@pytest.mark.parametrize("cd", [torch.float32, BF])
@pytest.mark.parametrize("hidden,layers,ctx_dim,rows,warps", [
    (160, 2, 128, 16, 10),  # two unit blocks a warp above hidden 128, in 16-row blocks
    (192, 2, 192, 16, 12),
    (224, 1, 0, 16, 14),
    (256, 1, 256, 16, 16),
    (256, 2, 128, 16, 16),
    (128, 8, 128, 16, 16),  # the deepest stack at hidden 128: one m16 tile of rows
    (64, 2, 64, 32, 8),  # the shapes taken before keep their block
    (96, 2, 96, 32, 12),
    (128, 2, 0, 32, 16),
])
def test_bwd_block_refuses_what_the_kernel_does_not_take(hidden, layers, ctx_dim, rows, warps, cd):
    """The shapes the backward takes (hidden up to 256, 8-layer stacks; the
    refusals are test_bwd_block_refuses_what_the_kernel_still_does_not_take):
    the block, within a block's shared memory."""
    for step_ctx in (False, True):
        geo = lstm_ss.bwd_block(hidden, layers, 3, ctx_dim, cd, step_ctx)
        assert (geo.rows, geo.warps) == (rows, warps) and geo.smem <= SMEM
        assert geo.stages == (2 if rows == 16 else 4)
        assert geo.smem == lstm_ss._bwd_smem(hidden, layers, ctx_dim, step_ctx, geo.stages, cd == torch.float32,
                                             rows=rows, unit_blocks=hidden // (8 * warps))


@pytest.mark.parametrize("shape,match", [
    ((48, 2, 3, 0), "hidden a multiple of 32 up to 256.*got hidden=48"),
    ((288, 1, 3, 0), "hidden a multiple of 32 up to 256.*got hidden=288"),
    ((512, 1, 3, 0), "hidden a multiple of 32 up to 256.*got hidden=512"),
    ((128, 9, 3, 128), "1..8 layers, got 9"),
    ((128, 2, 0, 128), "1 <= d <= 8 coordinates a token, got d=0"),
    ((128, 2, 9, 128), "1 <= d <= 8 coordinates a token, got d=9"),
    ((128, 2, 3, 12), "ctx_dim a multiple of 8 up to hidden .*got ctx_dim=12, hidden=128"),
    ((128, 2, 3, 136), "ctx_dim a multiple of 8 up to hidden .*got ctx_dim=136, hidden=128"),
    ((256, 4, 3, 256), r"layers=4, hidden=256, ctx_dim=256: .* more than 232448"),
])
def test_bwd_block_refuses_what_the_kernel_still_does_not_take(shape, match):
    """Each shape the backward does not take: a ValueError that names it."""
    with pytest.raises(ValueError, match=match):
        lstm_ss.bwd_block(*shape)


@pytest.mark.parametrize("cd", [torch.float32, BF])
@pytest.mark.parametrize("k", [1, 4, 7, 8])
def test_peer_fwd_block_at_the_training_shapes(k, cd):
    """The training peer forward takes the serve tier's peer context block
    at the aligned presets' widths (C = 128, d = 3; K = 7 at
    stacked-ss-crossuser-10s, 4 with --peer-align on stacked-ss-crossuser):
    whole viewers of 16 warps; f32 64 rows in 32 x 8 tiles with W from L2,
    bf16 W resident."""
    geo = lstm_align.peer_fwd_block(128, k, 3, cd)
    want = fused_lstm.peer_tc_rows(128, k, 3) if cd == BF else fused_lstm.peer_tf32_rows(128, k, 3)
    assert geo == want and geo.warps == 16 and geo.rows_v * k <= geo.rp <= 64 and geo.smem <= SMEM
    assert geo.w_res == (cd == BF) and geo.mt == 2
    if k == 7:
        assert (geo.rows_v, geo.rp) == (9, 64)


def test_peer_fwd_block_refuses_what_the_kernels_do_not_take():
    for c in (16, 48, 160):
        with pytest.raises(ValueError, match=f"ctx_dim in \\(32, 64, 96, 128\\), got {c}"):
            lstm_align.peer_fwd_block(c, 7, 3)
    for d in (0, 9):
        with pytest.raises(ValueError, match="1 <= d <= 8 window features"):
            lstm_align.peer_fwd_block(128, 7, d, BF)
    with pytest.raises(ValueError, match="K = 257 peers"):
        lstm_align.peer_fwd_block(128, 257, 3)
    assert lstm_align.peer_fwd_block(32, 9, 3, BF).rows_v * 9 <= 256
    assert lstm_align.peer_fwd_block(128, 256, 3) == fused_lstm.peer_tf32_rows(128, 256, 3)


# ---------------------------------------------- row 5's backward: the teacher-forced mode of ss_bwd_kernel


def _warp_order(hidden):
    """Gate columns in the order the teacher-forced backward's dx partials
    sum them: warp w's 32 columns (gate q's units 8w .. 8w + 7, q = 0..3),
    one chunk of 4 k8 steps a warp, the warps' partials added in order."""
    return torch.tensor([q * hidden + 8 * w + j for w in range(hidden // 8) for q in range(4) for j in range(8)])


@pytest.mark.parametrize("cd", [torch.float32, BF])
@pytest.mark.parametrize("d", [3, 67, 131])
def test_teacher_forced_bwd_pack_and_products(d, cd):
    """lstm_seq_states' backward at d = 3 (every encoder, the peer encoders,
    seq2seq-tf-30's decoder) and d = 3 + C (the teacher-forced decoder with
    video-fusion's C = 64 or crossuser's C = 128 static context): layer 0's
    input splits into 3 narrow columns and C wide ones (lstm_train.bwd_split);
    read back as B fragments, each layer's packed stream is Wᵀ in the
    product's order (layer 0 [dh (W[d:]) | the wide columns (W[3:d])],
    layer 1 [dh (W[H:]) | the layer below's h (W[:H])]); its product,
    emulated as the tensor cores compute it, and the narrow dx, the warps'
    partials over their own 32 gate columns added in warp order, equal the
    plain version's dgates · Wᵀ (``mm``) within the three-pass bound in f32
    and 1e-5 relative in bf16."""
    hidden, layers = 128, 2
    narrow, wide = lstm_train.bwd_split(d)
    assert (narrow, wide) == (3, d - 3)
    rng = np.random.default_rng(d)
    ps = _stack(rng, d, layers, hidden)
    packed = lstm_ss.pack_bwd_weights(ps, narrow, wide, cd)
    dg = torch.tensor(rng.normal(size=(37, 4 * hidden)).astype(np.float32) * 0.1)
    bound = 2.0 ** -19 + 12 * 2.0 ** -23 + 16 * 2.0 ** -24
    for l in range(layers):
        n_rows = hidden + wide if l == 0 else 2 * hidden
        b = _fragments(packed[l], n_rows, hidden, cd == torch.float32).float()
        w = round_to(ps[l].w, cd)
        d_in = d if l == 0 else hidden
        assert torch.equal(b, torch.cat([w[d_in:], w[narrow:d_in] if l == 0 else w[:hidden]]).t())
        ref = mm(dg, ps[l].w.t(), cd)  # the plain version's dz = [input grad | dh]
        want = torch.cat([ref[:, d_in:], ref[:, narrow:d_in] if l == 0 else ref[:, :d_in]], dim=1)
        cols = [(b, want)]
        if l == 0:  # dx of the narrow columns: W[:3]ᵀ with the gate columns in warp order
            order = _warp_order(hidden)
            cols.append((w[:narrow].t()[order], ref[:, :narrow]))
            dg_cols = [dg, dg[:, order]]
        else:
            dg_cols = [dg]
        for a, (bm, wm) in zip(dg_cols, cols):
            if cd == torch.float32:
                got = _three_pass(a.numpy(), bm.numpy())
                scale = np.abs(a.numpy()).astype(np.float64) @ np.abs(bm.numpy()).astype(np.float64)
                assert (np.abs(got - wm.numpy()) <= bound * scale + 1e-30).all()
            else:
                got = round_to(a, BF).double() @ bm.double()
                torch.testing.assert_close(got.float(), wm, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cd", [torch.float32, BF])
@pytest.mark.parametrize("hidden,layers,d", [
    (128, 1, 3),    # seq2seq-tf-30's (and lstm-xyz-10's) encoder and decoder; the crossuser peer
                    # encoders through lstm_seq (H = ctx_dim = 128, K·B rows)
    (128, 2, 3),    # the crossuser and video-fusion encoders, T = 30 and 100
    (64, 1, 3),     # a peer encoder of ctx_dim 64
    (128, 2, 67),   # video-fusion's teacher-forced decoder: D = 3 + C, C = 64
    (128, 2, 131),  # the crossuser teacher-forced decoder, C = 128
    (128, 3, 3),    # the card tests' deepest stack: a ring of 2 k-pairs in f32
])
def test_teacher_forced_bwd_block_at_the_training_shapes(hidden, layers, d, cd):
    """Every shape the training entry points send lstm_seq_states'
    backward: the scheduled-sampling decoder's block with layer 0's wide
    columns as a per-step context (no dctx sums): 32 rows in hidden / 8
    warps, the deepest W ring that fits, within a block's shared memory."""
    geo = lstm_train.bwd_block(hidden, layers, d, cd)
    narrow, wide = lstm_train.bwd_split(d)
    assert geo == lstm_ss.bwd_block(hidden, layers, narrow, wide, cd, True)
    assert (geo.rows, geo.warps) == (32, hidden // 8) and geo.smem <= SMEM
    assert geo.stages == (2 if layers == 3 and cd == torch.float32 else 4)
    e = 4 if cd == torch.float32 else 2
    assert geo.smem == (32 * (4 * hidden + 16 // e) * e + 8 * layers * 32 * hidden + 4 * 32 * 8 * (1 + hidden // 8)
                        + (hidden // 8) * 1024 * geo.stages)


@pytest.mark.parametrize("cd", [torch.float32, BF])
@pytest.mark.parametrize("shape,want", [
    # taken: (rows, warps, ring stages) of the block
    ((160, 1, 3), (16, 10, 2)),  # hidden above 128: two unit blocks a warp, 16 rows
    ((192, 2, 3), (16, 12, 2)),
    ((256, 1, 3), (16, 16, 2)),
    ((256, 2, 264), (16, 16, 2)),  # the widest input: 8 narrow columns, then hidden in n8 tiles
    ((128, 4, 3), None),  # f32: 16 rows; bf16: 32 rows with a ring of 2
    ((128, 8, 3), (16, 16, 2)),  # the deepest stack
    ((128, 8, 131), (16, 16, 2)),
    # still refused: a ValueError that names the shape
    ((48, 1, 3), "lstm_seq_states' backward takes hidden a multiple of 32 up to 256.*got hidden=48"),
    ((288, 1, 3), "lstm_seq_states' backward takes hidden a multiple of 32 up to 256.*got hidden=288"),
    ((128, 9, 3), "lstm_seq_states' backward takes 1..8 layers, got 9"),
    ((128, 1, 0), "takes 1..136 input columns at hidden=128 .*got d=0"),
    ((128, 1, 137), "takes 1..136 input columns at hidden=128 .*got d=137"),
    ((256, 1, 265), "takes 1..264 input columns at hidden=256 .*got d=265"),
    ((256, 4, 3), r"backward at d=3 \(3 \+ 0 input columns\): layers=4, hidden=256.* more than"),
])
def test_teacher_forced_bwd_block_refuses_what_the_kernel_does_not_take(shape, want, cd):
    """Shapes the FMA backward took: those the tensor-core body takes again
    (hidden up to 256, 8-layer stacks), with their blocks; and those it
    still does not take, each refused by a ValueError that names it (hidden
    256 at 4 layers in f32 only: the bf16 A buffer is half the size)."""
    f32 = cd == torch.float32
    if want is None:
        want = (16, 16, 2) if f32 else (32, 16, 2)
    if isinstance(want, str) and not (not f32 and "more than" in want):
        with pytest.raises(ValueError, match=want):
            lstm_train.bwd_block(*shape, cd)
        return
    if isinstance(want, str):
        want = (16, 16, 2)
    geo = lstm_train.bwd_block(*shape, cd)
    narrow, wide = lstm_train.bwd_split(shape[2])
    assert (geo.rows, geo.warps, geo.stages) == want
    assert geo == lstm_ss.bwd_block(shape[0], shape[1], narrow, wide, cd, True)
    assert [lstm_train.bwd_split(d) for d in (1, 8, 9, 16, 136)] == [(1, 0), (8, 0), (1, 8), (8, 8), (8, 128)]
