"""Port ops/snake.py and ops/lstm.py against the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotokenization_tpu.ops import lstm as JL
from audiotokenization_tpu.ops import snake as JS
from audiotokenization_tpu_torch.convert import params_from_jax
from audiotokenization_tpu_torch.ops import lstm as TL
from audiotokenization_tpu_torch.ops import snake as TS


def test_snake_beta_matches_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 16, 200) * 2).astype(np.float32)
    alpha = (rng.randn(16) * 0.3).astype(np.float32)
    beta = (rng.randn(16) * 0.3).astype(np.float32)
    ref = JS.snake_beta(jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta))
    got = TS.snake_beta(torch.from_numpy(x), torch.from_numpy(alpha), torch.from_numpy(beta))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    mod = TS.SnakeBeta(16)  # alpha = beta = 0 in log scale: x + sin²(x) / (1 + 1e-9)
    xt = torch.from_numpy(x)
    torch.testing.assert_close(mod(xt), xt + torch.sin(xt) ** 2, rtol=1e-6, atol=1e-6)
    assert mod.alpha.shape == mod.beta.shape == (16,)


def _port_lstm(tree, in_f, hid, layers, bidirectional):
    m = TL.init_lstm(in_f, hid, num_layers=layers, bidirectional=bidirectional,
                     generator=torch.Generator().manual_seed(0))
    sd = {k.removeprefix("lstm."): v
          for k, v in params_from_jax({"lstm": jax.tree.map(np.asarray, tree)}).items()}
    m.load_state_dict(sd)
    return m


@pytest.mark.parametrize("layers,bidirectional", [(1, False), (2, False), (1, True)])
def test_res_lstm_matches_jax(layers, bidirectional):
    F, T = 24, 30
    hid = F // 2 if bidirectional else F
    tree = JL.init_lstm(jax.random.key(layers), F, hid, num_layers=layers,
                        bidirectional=bidirectional)
    x = np.random.RandomState(1).randn(2, F, T).astype(np.float32)
    ref = JL.res_lstm(jnp.asarray(x), tree, num_layers=layers, bidirectional=bidirectional)
    m = _port_lstm(tree, F, hid, layers, bidirectional)
    with torch.no_grad():
        got = TL.res_lstm(torch.from_numpy(x), m)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_lstm_masked_path_is_refused():
    """The masked path takes per-sample prefix masks (tests/test_torch_ragged.py);
    a mask with a hole, or of another shape, is refused."""
    m = TL.init_lstm(4, 4, num_layers=1, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="prefix"):
        TL.res_lstm(torch.zeros(1, 4, 3), m, valid=torch.tensor([[True, False, True]]))
    with pytest.raises(ValueError, match="valid must be"):
        TL.res_lstm(torch.zeros(1, 4, 3), m, valid=torch.ones(3, dtype=torch.bool))


def test_init_lstm_uses_the_generator_only():
    """Same generator seed, same weights; the global generator is untouched."""
    state = torch.random.get_rng_state()
    a = TL.init_lstm(8, 16, num_layers=2, generator=torch.Generator().manual_seed(5))
    b = TL.init_lstm(8, 16, num_layers=2, generator=torch.Generator().manual_seed(5))
    assert torch.equal(torch.random.get_rng_state(), state)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert a.weight_hh_l1.abs().max() <= 1 / 4
