"""The dW reductions' pack pass on the CPU: its plain version
(``lstm_train._pack_reference``, which ``dw_pack`` runs on CPU tensors)
lays out each layer's z as ``[h_{t-1}, input[narrow:], input[:narrow], 1]``
padded to whole runs of 8, and the product of that packed z with dgates,
its rows put back in dW's order as the kernel writes them, is the plain dW
and db of every reduction (teacher-forced, scheduled sampling with and
without a context, the lockstep decoder, its peer encoder). The card tests
hold the kernel against this plain version."""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import numpy as np
import pytest
import torch

from longterm360fov_tpu_torch.models.cell import LSTMParams
from longterm360fov_tpu_torch.ops import lstm_align, lstm_ss, lstm_train

B, T, D, H, C, L, K = 5, 4, 3, 32, 16, 2, 3


def _rows(n_in, hidden, narrow):
    """dW's row of each packed feature (the kernel's dw_row): h → in + f,
    the wide input → narrow + u, x_t → u - wide, the constant → db's row."""
    wide = n_in - narrow
    return [n_in + f if f < hidden else
            narrow + f - hidden if f - hidden < wide else
            f - hidden - wide if f - hidden < n_in else n_in + hidden
            for f in range(n_in + hidden + 1)]


def _case(loader):
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32))

    n0 = D if loader == "tf" else D + (0 if loader == "ss0" else C)
    ps = [LSTMParams(t(n0 + H, 4 * H), t(4 * H)), LSTMParams(t(2 * H, 4 * H), t(4 * H))]
    h0, c0 = t(L, B, H), t(L, B, H)
    dg = [t(B, T, 4 * H) for _ in range(L)]
    if loader == "tf":
        xs = t(B, T, D)
        res = lstm_train._forward_reference(ps, xs, h0, c0, torch.float32)
        return lstm_train.lstm_dw, (ps, xs, h0, res, dg), [n0, H], lstm_train._dw_reference(ps, xs, h0, res, dg)
    coins = torch.tensor((rng.random((T, B, 1)) < 0.5).astype(np.float32))
    y0, teacher, ys = t(B, D), t(T, B, D), t(B, T, D)
    res = lstm_train._forward_reference(ps, t(B, T, n0), h0, c0, torch.float32)
    if loader == "peer":
        peer, pxs, php, dpg = LSTMParams(t(D + C, 4 * C), t(4 * C)), t(B * K, T, D), t(B * K, T, C), t(B * K, T, 4 * C)
        return lstm_align.peer_dw, (peer, pxs, php, dpg), [D], [lstm_align._peer_dw_reference(peer, pxs, php, dpg)]
    if loader == "align":
        args = (ps, h0, y0, teacher, coins, t(B, K), t(B * K, T, C), ys, res, dg)
        return lstm_align.dec_dw, args, [n0, H], lstm_align._dw_reference(*args)
    args = (ps, h0, y0, teacher, coins, None if loader == "ss0" else t(B, C), ys, res, dg)
    return lstm_ss.ss_dw, args, [n0, H], lstm_ss._dw_reference(*args)


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("loader", ["tf", "ss0", "ss", "align", "peer"])
def test_packed_z_times_dgates_is_the_plain_dw(loader, cd):
    dw, args, ins, ref = _case(loader)
    dgates = args[-1] if isinstance(args[-1], list) else [args[-1]]
    hidden = ref[0].w.shape[1] // 4
    for l, (n_in, want) in enumerate(zip(ins, ref)):
        zp = lstm_train.dw_pack(dw, *args, layer=l, compute_dtype=cd)
        assert zp.dtype == cd and zp.shape == (dgates[l].shape[0] * T, lstm_train.dw_zld(n_in, hidden))
        assert zp.shape[1] % 8 == 0 and not zp[:, n_in + hidden + 1:].any()
        assert (zp[:, n_in + hidden] == 1).all()  # the constant feature of db
        g = dgates[l].reshape(-1, 4 * hidden)
        prod = zp[:, :n_in + hidden + 1].double().t() @ g.to(cd).double()  # the tier rounds both operands
        got = torch.empty_like(prod)
        got[_rows(n_in, hidden, D if l == 0 else 0)] = prod
        plain = dw(*args, compute_dtype=cd)
        plain = plain[l] if isinstance(plain, list) else plain
        assert ((got[:-1] - plain.w.double()).abs().max() / plain.w.abs().max()).item() <= 1e-6
        assert torch.equal(want.w, plain.w) == (cd == torch.float32)
        assert torch.allclose(g.double().sum(dim=0), plain.b.double())  # db sums the unrounded dgates


def test_pack_layer_outside_the_layers_raises():
    dw, args, _, _ = _case("tf")
    with pytest.raises(ValueError, match="pack_layer 2"):
        lstm_train.dw_pack(dw, *args, layer=2)


def test_dw_splits_count_144_feature_tiles():
    """Two blocks per SM from the first layer's tiles (4 column tiles of
    128 times one 144-feature tile at in = 3, 132 features, two at
    in = 131), in whole waves of them so that a slice sums at most 8192
    rows; one slice when B·T is under 64 rows."""
    assert lstm_train.dw_splits(4096, 30, 128, 3, 132) == 66
    assert lstm_train.dw_splits(4096, 100, 128, 131, 132) == 66  # 409,600 rows: 2 waves of 33
    assert lstm_train.dw_splits(4096 * 7, 100, 128, 3, 132) == 396  # the peer rows: 6 waves of 66
    assert lstm_train.dw_splits(1, 30, 128, 3, 132) == 1
