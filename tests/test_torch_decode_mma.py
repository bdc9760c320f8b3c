"""The host side of the kernels on the tensor cores that carry one step or
one rollout: the transformer decode's bf16 body
(``csrc/transformer_decode_mma.cuh``) and f32 body on three-pass TF32
(``csrc/transformer_decode_f32mma.cuh``: the rows-a-block chooser, their
shared memory and their weight streams' order) and the bf16 LSTM cell
(``csrc/lstm_mma.cuh`` cell_step: its block and its ring over W as stored),
on the CPU. The kernels themselves are held against their plain versions on
the card (``tests/test_torch_kernel_cuda.py``)."""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import numpy as np
import pytest
import torch

from longterm360fov_tpu_torch.models import transformer
from longterm360fov_tpu_torch.models.cell import mm, round_to
from longterm360fov_tpu_torch.models.seq2seq import Seq2SeqConfig
from longterm360fov_tpu_torch.ops import fused_lstm
from longterm360fov_tpu_torch.ops import transformer_decode as td

SMEM = 232448  # dynamic shared memory a Hopper block may use


@pytest.mark.parametrize("batch,rows", [(1, 32), (257, 32), (4096, 32), (8384, 32), (8385, 64), (8448, 64),
                                        (16384, 64), (65536, 64)])
def test_decode_rows_fills_the_sms(batch, rows):
    """64-row blocks where they fill the 132 SMs of an H100 SXM
    (ceil(B / 64) >= 132), else 32-row blocks: B = 4096 spreads over 128
    SMs, not 64."""
    assert td.decode_rows(batch, 132) == rows
    blocks = -(-batch // rows)
    assert blocks >= 132 or rows == 32


@pytest.mark.parametrize("n_sm,batch,rows", [(114, 7232, 32), (114, 7233, 64), (8, 448, 32), (8, 449, 64)])
def test_decode_rows_reads_the_cards_sm_count(n_sm, batch, rows):
    """The switch follows the SM count the wrapper reads from the card."""
    assert td.decode_rows(batch, n_sm) == rows


@pytest.mark.parametrize("tier", ["none", "per_row", "grouped"])
@pytest.mark.parametrize("layers", range(1, 9))
def test_decode_block_fits_at_every_depth_and_tier(layers, tier):
    """The chosen block's shared memory (x, q, k, v in f32; the A rows and
    two stream stages in bf16; the fed-back token) fits a block at every
    L <= 8 and every tier, at the smaller and the larger batch: the layout
    holds one layer at a time and the peers' K/V stay in device memory."""
    for batch in (4096, 16384):
        assert td.decode_smem_bytes(td.decode_rows(batch, 132)) <= SMEM
    assert (td.decode_smem_bytes(64), td.decode_smem_bytes(32)) == (223232, 146432)


def test_decode_smem_refuses_other_blocks():
    with pytest.raises(ValueError, match="64 or 32 rows"):
        td.decode_smem_bytes(48)


@pytest.mark.parametrize("rows", [64, 32])
@pytest.mark.parametrize("layers", range(1, 9))
def test_f32_decode_block_fits_at_every_depth(layers, rows):
    """The f32 body's block (x, the A rows, q, k and v in f32; the weight
    stream's two stages of hi and lo planes of 16 k-columns; the fed-back
    token) fits at every L <= 8 and both row counts: the layout holds one
    layer at a time, the MLP's hidden layer in four slabs over q, k, v and
    the A rows."""
    smem = td.decode_smem_bytes(rows, torch.float32)
    assert smem == {64: 210944, 32: 125952}[rows] <= SMEM
    assert 4 * rows * (4 * 128 + 4) <= smem  # u's four 128-column slabs fit over four (rows, LDX) buffers


@pytest.mark.parametrize("rows", [0, 16, 48, 96, 128])
def test_f32_decode_smem_refuses_other_blocks(rows):
    with pytest.raises(ValueError, match=f"64 or 32 rows, got {rows}"):
        td.decode_smem_bytes(rows, torch.float32)


def _layer(peers):
    cfg = Seq2SeqConfig(hidden=128, layers=1, h_in=4, h_out=4)
    return transformer.init(torch.Generator().manual_seed(int(peers)), cfg, device="cpu")["dec"][0]


@pytest.mark.parametrize("peers", [True, False])
def test_stream_chunks_follow_the_layers_products(peers):
    """The stream's chunks, taken in order and cut at each product's depth,
    are the products' W slices in the order the layer runs them: self Wq,
    Wk, Wv, Wo; cross Wq, Wo; peer Wq, Wo; W1's four 128-column slabs; W2.
    16 chunks of 128 x 128 with peers, 14 without."""
    chunks = td.stream_chunks(peers)
    assert len(chunks) == (16 if peers else 14)
    layer = _layer(peers)
    mats = [layer["self_attn"][m] for m in ("wq", "wk", "wv", "wo")]
    mats += [layer["cross_attn"][m] for m in ("wq", "wo")]
    mats += [layer["peer_attn"][m] for m in ("wq", "wo")] if peers else []
    mats += [layer["mlp"]["w1"][:, n0:n0 + 128] for n0 in range(0, 512, 128)]
    mats += [layer["mlp"]["w2"]]
    it = iter(chunks)
    for want in mats:
        pieces = []
        for _ in range(want.shape[0] // 128):
            (sub, leaf), k0, n0 = next(it)
            w = layer[sub][leaf]
            assert k0 % 128 == 0 and k0 + 128 <= w.shape[0] and n0 + 128 <= w.shape[1]
            pieces.append(w[k0:k0 + 128, n0:n0 + 128])
        assert torch.equal(torch.cat(pieces), want)
    assert next(it, None) is None


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("hidden", [1, 8, 40, 100, 128, 256, 272, 512, 1024])
@pytest.mark.parametrize("d_in", [3, 128, 1024])
def test_cell_tc_rows(d_in, hidden, bf16):
    """The cell's block (cell_block) in both tiers: W's columns of the block
    resident in the first candidate block of 16 warps whose shared memory
    holds them (f32: 64 rows x 64 units, then 128 x 32; bf16: 128 x 64),
    units no more than hidden rounded up to whole warp tiles (32 rows x 8
    units in f32, x 16 in bf16); else 128-row blocks of 32 (f32) or 64
    (bf16) units that stream W beside z; their unit blocks cover H."""
    g = fused_lstm.cell_block(d_in, hidden, bf16)
    tile = 16 if bf16 else 8
    whole = -(-hidden // tile) * tile
    cands = [(128, 64)] if bf16 else [(64, 64), (128, 32)]
    fits = [f for f in (fused_lstm.cell_geom(r, min(u, whole), True, d_in, hidden, bf16) for r, u in cands)
            if f.smem <= 232448]
    assert g == (fits[0] if fits else fused_lstm.cell_geom(128, min(64 if bf16 else 32, whole), False, d_in,
                                                           hidden, bf16))
    assert g.units % tile == 0 and g.units <= whole and g.warps == g.rows // 32 * (g.units // tile) <= 16
    assert g.smem <= 232448 and -(-hidden // g.units) * g.units - hidden < g.units
    assert fused_lstm.cell_block(3, 128, False) == (64, 64, 16, True, 205824)
    assert fused_lstm.cell_block(128, 128, False) == (128, 32, 16, True, 212992)
    assert fused_lstm.cell_block(1024, 128, False) == (128, 32, 16, False, 143360)
    assert fused_lstm.cell_block(3, 128, True) == (128, 64, 16, True, 125440)
    assert fused_lstm.cell_block(128, 128, True) == (128, 64, 16, True, 176128)


@pytest.mark.parametrize("batch,hidden,bf16,want", [(16384, 128, False, 66), (16384, 128, True, 66), (100, 128, False, 2),
                                                    (262144, 1024, False, 2048), (16384, 40, False, 132)])
def test_cell_grid_fills_the_sms(batch, hidden, bf16, want):
    """Blocks along the batch (cell_grid): with W resident, one 16-warp block
    an SM for each unit block (132 SMs), no more than the row tiles; W
    streamed, every row tile its own block."""
    geo = fused_lstm.cell_block(3, hidden, bf16)
    assert fused_lstm.cell_grid(geo, batch, hidden, 132) == want


def test_cell_tc_rows_refuses_what_it_does_not_take():
    """What the tensor-core cell refused before its unit-block grid (bf16:
    hidden not a multiple of 16 or past 256, and x past shared memory
    beside the ring: D_in 641 and 2000 at H = 128) is taken in both tiers;
    an empty shape, and a hidden past the grid's 65,535 unit blocks, are
    still refused, the shape named."""
    for bf16 in (False, True):
        for hidden in (8, 40, 100, 272, 512, 1024):
            assert fused_lstm.cell_block(3, hidden, bf16).smem <= 232448
        for d_in in (640, 641, 2000):
            assert fused_lstm.cell_block(d_in, 128, bf16).smem <= 232448
        with pytest.raises(ValueError, match="D_in=3, hidden=0"):
            fused_lstm.cell_block(3, 0, bf16)
        with pytest.raises(ValueError, match="D_in=0, hidden=128"):
            fused_lstm.cell_block(0, 128, bf16)
        units = fused_lstm.cell_block(3, 10 ** 6, bf16).units
        with pytest.raises(ValueError, match=f"hidden={65535 * units + 1}"):
            fused_lstm.cell_block(3, 65535 * units + 1, bf16)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("d_in,hidden", [(3, 128), (16, 32), (128, 128), (131, 64), (1, 256), (3, 96),
                                         (5, 160), (3, 40), (7, 100), (2, 272), (3, 1)])
def test_cell_ring_over_w_as_stored_is_the_gate_product(d_in, hidden, bf16):
    """The ring over z and W as stored, rebuilt on the CPU: for each unit
    block, its chunks of the k-steps (cell_k_steps: 4 k8 steps a chunk in
    f32, 2 k16 in bf16), z's columns and W's rows past D_in or H zeros,
    and its stage's W columns (cell_w_columns, zeros past H); the stage
    products summed over the chunks and put back at their gate columns equal
    [x, h] @ W with the operands in the tier's type and f32 sums (in another
    order: 1e-5); every row of W is in exactly one step, every column of W
    in exactly one unit block."""
    rng = np.random.default_rng(d_in + hidden)
    dt = torch.bfloat16 if bf16 else torch.float32
    rows = 37
    w = torch.tensor(rng.normal(size=(d_in + hidden, 4 * hidden)).astype(np.float32) * 0.2)
    x = torch.tensor(rng.normal(size=(rows, d_in)).astype(np.float32))
    h = torch.tensor(rng.uniform(-1, 1, size=(rows, hidden)).astype(np.float32))
    xr, hr, wr = round_to(x, dt), round_to(h, dt), round_to(w, dt)
    geo = fused_lstm.cell_block(d_in, hidden, bf16)
    ks = 16 if bf16 else 8
    steps = fused_lstm.cell_k_steps(d_in, hidden, bf16)
    assert len(steps) == -(-d_in // ks) + -(-hidden // ks)
    seen_rows = torch.zeros(d_in + hidden, dtype=torch.int64)
    seen_cols = torch.zeros(4 * hidden, dtype=torch.int64)
    gates = torch.zeros(rows, 4 * hidden)
    for blk in range(-(-hidden // geo.units)):
        cols = fused_lstm.cell_w_columns(hidden, geo.units, blk)
        assert cols.shape == (4 * geo.units,)
        live = cols >= 0
        seen_cols[cols[live]] += 1
        acc = torch.zeros(rows, 4 * geo.units)
        for c0 in range(0, len(steps), 32 // ks):  # the ring's chunks of 32 k-rows
            zst, wst = torch.zeros(rows, 32), torch.zeros(32, 4 * geo.units)
            for i, (part, col, valid, k0) in enumerate(steps[c0:c0 + 32 // ks]):
                zst[:, ks * i:ks * i + valid] = (xr if part == "x" else hr)[:, col:col + valid]
                wst[ks * i:ks * i + valid, live] = wr[k0:k0 + valid][:, cols[live]]
                if blk == 0:
                    seen_rows[k0:k0 + valid] += 1
            acc += zst @ wst
        gates[:, cols[live]] = acc[:, live]
    assert torch.equal(seen_rows, torch.ones_like(seen_rows)) and torch.equal(seen_cols, torch.ones_like(seen_cols))
    torch.testing.assert_close(gates, mm(torch.cat([x, h], dim=1), w, dt), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("peers", [True, False])
def test_f32_stream_chunks_follow_the_layers_products(peers):
    """The f32 stream's chunks of Wᵀ (128 rows x 16 k-columns), taken in
    order and cut at each product's depth, are the products' Wᵀ blocks in
    the order the layer runs them, as the bf16 stream's are: the same
    products over the same k-rows, k-contiguous."""
    chunks = td.stream_chunks(peers, torch.float32)
    assert len(chunks) == (16 if peers else 14) * 128 // td.F32_KC
    layer = _layer(peers)
    mats = [layer["self_attn"][m] for m in ("wq", "wk", "wv", "wo")]
    mats += [layer["cross_attn"][m] for m in ("wq", "wo")]
    mats += [layer["peer_attn"][m] for m in ("wq", "wo")] if peers else []
    mats += [layer["mlp"]["w1"][:, n0:n0 + 128] for n0 in range(0, 512, 128)]
    mats += [layer["mlp"]["w2"][k0:k0 + 128] for k0 in range(0, 512, 128)]
    it = iter(chunks)
    for want in mats:
        pieces = []
        for _ in range(128 // td.F32_KC):
            (sub, leaf), n0, k0 = next(it)
            wt = layer[sub][leaf].t()  # the kernel's B operand
            assert n0 % 128 == 0 and k0 % td.F32_KC == 0 and n0 + 128 <= wt.shape[0] and k0 + 16 <= wt.shape[1]
            pieces.append(wt[n0:n0 + 128, k0:k0 + td.F32_KC])
        got = torch.cat(pieces, dim=1)  # one 128 x 128 block of Wᵀ, k-contiguous
        assert torch.equal(got.t(), want)
        x = torch.randn(5, 128, generator=torch.Generator().manual_seed(3))
        torch.testing.assert_close(sum(x[:, k0:k0 + 16] @ p.t() for k0, p in zip(range(0, 128, 16), pieces)),
                                   x @ want, rtol=1e-5, atol=1e-5)
    assert next(it, None) is None
