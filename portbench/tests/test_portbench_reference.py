"""The plain references against the port at a small size on the CPU: the
same weights give the same parameter names and shapes and the same tokens."""
import pytest
import torch

from portbench.harness.bench import module_from_path
from portbench.harness.weights import make_weights
from portbench.reference.common import code_gaps, vq_distances


def _port_codec(cfgd, weights):
    from audiotokenization_tpu_torch.config import from_dict
    from audiotokenization_tpu_torch.models.codec import Codec

    cfg = from_dict({k: cfgd[k] for k in ("model", "train", "dataset")})
    with torch.device("meta"):
        codec = Codec(cfg, generator=torch.Generator())
    codec = codec.to_empty(device="cpu")
    codec.load_state_dict(weights)
    return cfg, codec.eval()


@pytest.mark.parametrize("family", ["tiny_bigcodec", "tiny_conformer"])
def test_specs_are_the_port_state_dict(family, request):
    cfgd = request.getfixturevalue(family)
    ref = module_from_path(cfgd["reference"])
    weights = make_weights(ref.param_specs(cfgd), 3, "cpu")
    _, codec = _port_codec(cfgd, weights)
    want = {k: tuple(v.shape) for k, v in codec.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in weights.items()} == want


@pytest.mark.parametrize("family", ["tiny_bigcodec", "tiny_conformer"])
def test_reference_tokens_equal_the_port(family, request):
    """Each utterance alone through the reference, and the batch through
    the port's ragged tokenizer: the same codes, every frame."""
    from audiotokenization_tpu_torch.config import codec_hop
    from audiotokenization_tpu_torch.utils.ragged import make_ragged_tokenizer

    cfgd = request.getfixturevalue(family)
    ref = module_from_path(cfgd["reference"])
    weights = make_weights(ref.param_specs(cfgd), 2 ** 31 + 5, "cpu")
    cfg, codec = _port_codec(cfgd, weights)
    hop = codec_hop(cfg)
    g = torch.Generator().manual_seed(0)
    lengths = [hop * n for n in (37, 50, 12)]
    wavs = torch.zeros(3, max(lengths))
    for i, n in enumerate(lengths):
        wavs[i, :n] = 0.3 * torch.randn(n, generator=g)
    codes = make_ragged_tokenizer(cfg, device="cpu")(codec, wavs, torch.tensor(lengths))
    with torch.no_grad():
        lats = ref.encode(weights, cfgd, [wavs[i, :n] for i, n in enumerate(lengths)])
    for i, (n, lat) in enumerate(zip(lengths, lats)):
        dist = vq_distances(weights, lat)
        assert dist.shape[0] == n // hop
        assert torch.equal(dist.argmin(dim=1), codes[0, i, :n // hop].long())
        assert float(code_gaps(dist, codes[0, i, :n // hop]).max()) == 0.0


def test_code_gaps():
    dist = torch.tensor([[0.5, 0.1, 0.3], [0.2, 0.9, 0.2]])
    assert torch.allclose(code_gaps(dist, torch.tensor([1, 0])), torch.tensor([0.0, 0.0]))
    assert torch.allclose(code_gaps(dist, torch.tensor([2, 1])), torch.tensor([0.2, 0.7]))
