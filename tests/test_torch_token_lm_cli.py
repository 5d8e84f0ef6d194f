"""Stage 2 through the port's CLIs, on the tiny codec of
``__graft_entry__._tiny_config()`` (64 codes, hop 10) and a corpus of 4
WAVs: ``cli.train_token_lm`` for 3 steps, then ``cli.synthesize
--lm_ckpt`` (the counterpart of JAX's
``test_stage2_pipeline_train_lm_then_synthesize``); a JAX token-LM run
(Orbax, written from JAX's ``init_token_lm``, no training) converted by
``scripts/jax_run_to_torch.py --token_lm``, whose greedy samples equal
JAX's; ``--sequence_parallel`` after ``--lm_ckpt``; the refusals and the
default device."""
import dataclasses
import json
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

import __graft_entry__ as GE
from audiotokenization_tpu.data.audio_io import write_wav
from audiotokenization_tpu.models import token_lm as JL
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch.cli import synthesize, train_token_lm
from audiotokenization_tpu_torch.models import codec as TC
from audiotokenization_tpu_torch.models import token_lm as TL

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import jax_run_to_torch  # noqa: E402

VOCAB = 64 + 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: as fast at these sizes, and it does not
    oversubscribe the cores that parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """A generator-only port run dir of the tiny codec (random weights from
    seed 0) and a filelist of 4 WAVs of 900 samples."""
    tmp = tmp_path_factory.mktemp("stage2")
    cfg = PC.from_dict(dataclasses.asdict(GE._tiny_config()))
    run = tmp / "codec"
    (run / "ckpt" / "0").mkdir(parents=True)
    PC.save_config(cfg, run / "config.json")
    codec = TC.init_codec(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    torch.save({"step": 0, "gen": codec.state_dict()}, run / "ckpt" / "0" / "state.pt")
    rng = np.random.RandomState(11)
    lines = []
    for i in range(4):
        f = tmp / f"u{i}.wav"
        write_wav(f, (rng.randn(900) * 0.1).astype(np.float32), 16000)
        lines.append(str(f))
    (tmp / "filelist.txt").write_text("\n".join(lines) + "\n")
    return tmp, run


def test_train_token_lm_then_synthesize(stage1):
    tmp, run = stage1
    lm_dir = tmp / "lm"
    train_token_lm.main(["--codec_ckpt", str(run), "--filelist", str(tmp / "filelist.txt"),
                         "--run_dir", str(lm_dir), "--batch_size", "2", "--max_steps", "3",
                         "--crop_seconds", "0.05", "--log_every", "1", "--device", "cpu"])
    assert sorted(p.name for p in (lm_dir / "ckpt").iterdir()) == ["3"]
    state = torch.load(lm_dir / "ckpt" / "3" / "state.pt", weights_only=True)
    assert state["step"] == 3 and state["optim"]["count"] == 3
    logs = [json.loads(line) for line in (lm_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in logs] == [1, 2, 3]
    for r in logs:
        assert np.isfinite(r["loss"]) and r["ppl"] == pytest.approx(np.exp(r["loss"]), rel=1e-6)
    lm_cfg = TL.TokenLMConfig(vocab_size=VOCAB)
    lm = train_token_lm.load_token_lm(lm_dir, lm_cfg, device="cpu")
    fresh = TL.init_token_lm(lm_cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert not torch.equal(lm.embed, fresh.embed)  # trained, and what was saved is loaded

    out = tmp / "synth"
    wav = synthesize.main(["--codec_ckpt", str(run), "--lm_ckpt", str(lm_dir), "--seconds",
                           "0.1", "--num_samples", "2", "--out_dir", str(out), "--device", "cpu"])
    tokens = np.load(out / "tokens.npy")
    assert tokens.dtype == np.int16 and tokens.shape == (2, 1600 // 10)
    assert (tokens >= 0).all() and (tokens < 64).all()
    assert sorted(p.name for p in out.glob("sample_*.wav")) == ["sample_0.wav", "sample_1.wav"]
    assert wav.shape == (2, 1600) and np.isfinite(wav).all()
    want = TL.token_lm_generate_kv(lm, batch_size=2, length=160, temperature=1.0,
                                   generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(tokens, want.clamp(0, 63).numpy())
    # --sequence_parallel decodes the same samples (tests/test_torch_parallel_cli.py
    # runs it over several devices), within the repo's waveform tolerance
    sp = synthesize.main(["--codec_ckpt", str(run), "--lm_ckpt", str(lm_dir), "--seconds",
                          "0.1", "--num_samples", "2", "--out_dir", str(tmp / "synth_sp"),
                          "--sequence_parallel", "--device", "cpu"])
    np.testing.assert_array_equal(np.load(tmp / "synth_sp" / "tokens.npy"), tokens)
    np.testing.assert_allclose(sp, wav, rtol=1e-3, atol=2e-5)


def test_checkpoints_keep_the_two_newest(tmp_path):
    lm = TL.TokenLM(TL.TokenLMConfig(vocab_size=VOCAB, hidden_size=8, intermediate_size=8,
                                     num_layers=1, num_heads=2), generator=torch.Generator())
    opt = TL.make_token_lm_optimizer(PC.Config(), lm)
    for step in (10000, 20000, 20005):
        train_token_lm.save_token_lm(tmp_path, step, lm, opt)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["20000", "20005"]
    with pytest.raises(FileNotFoundError):
        train_token_lm.load_token_lm(tmp_path / "absent", lm.cfg, device="cpu")


def test_jax_token_lm_run_converts_and_samples_as_jax(tmp_path):
    lm_cfg = JL.TokenLMConfig(vocab_size=VOCAB)
    params = jax.jit(JL.init_token_lm, static_argnums=1)(jax.random.key(3), lm_cfg)
    tx = optax.adamw(1e-4, b1=0.8, b2=0.9)
    ckpt = tmp_path / "jax_lm" / "ckpt"
    with ocp.CheckpointManager(ckpt, options=ocp.CheckpointManagerOptions(
            max_to_keep=2, create=True)) as mngr:  # cli/train_token_lm.py's layout
        mngr.save(7, args=ocp.args.Composite(lm_params=ocp.args.StandardSave(params),
                                             opt_state=ocp.args.StandardSave(tx.init(params))))
        mngr.wait_until_finished()
    jax_run_to_torch.main(["--jax_run", str(tmp_path / "jax_lm"), "--out",
                           str(tmp_path / "torch_lm"), "--token_lm", str(VOCAB)])
    assert (tmp_path / "torch_lm" / "ckpt" / "7" / "state.pt").exists()
    lm = train_token_lm.load_token_lm(tmp_path / "torch_lm", TL.TokenLMConfig(vocab_size=VOCAB),
                                      device="cpu")
    want = np.asarray(JL.token_lm_generate_kv(params, lm_cfg, batch_size=2, length=24,
                                              key=jax.random.key(0), temperature=0.0))
    got = TL.token_lm_generate_kv(lm, batch_size=2, length=24, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_entry_points_default_to_cuda_and_raise_without_a_card(stage1, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    tmp, run = stage1
    lm_cfg = TL.TokenLMConfig(vocab_size=VOCAB)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.init_token_lm(lm_cfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_token_lm.main(["--codec_ckpt", str(run), "--filelist",
                             str(tmp / "filelist.txt"), "--run_dir", str(tmp_path / "lm")])
    lm = TL.TokenLM(lm_cfg, generator=torch.Generator())
    train_token_lm.save_token_lm(tmp_path, 1, lm, TL.make_token_lm_optimizer(PC.Config(), lm))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_token_lm.load_token_lm(tmp_path, lm_cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthesize.main(["--codec_ckpt", str(run), "--lm_ckpt", str(tmp_path)])
