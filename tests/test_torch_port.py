"""PyTorch port as a whole: it imports without JAX (and without
matplotlib, which only draws the result png), it refuses a CUDA run
without a card, and its CLI turns the README sentence into the same wav
as the JAX package's CLI on the same weights.

The slice test uses a tiny acoustic model (random weights from the JAX
initialiser, saved as an npz snapshot the way scripts/save_weights_npz.py
saves them) and the tracked vocoder snapshot, on a short utterance, both
packages on the CPU.  The wavs are compared to 1e-3 of full scale: the
mels agree to ~1e-5, and int16 rounding plus the vocoder's gain turn
that into a few LSB.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from fastspeech2_tpu.cli.common import load_model_for_inference
from fastspeech2_tpu.cli.synthesize_cli import main as jax_main
from fastspeech2_tpu.configs.config import load_yaml_configs
from fastspeech2_tpu.models.fastspeech2 import FastSpeech2 as JaxFastSpeech2
from fastspeech2_tpu.synthesis.pipeline import Synthesizer as JaxSynthesizer
from fastspeech2_tpu.utils.params_io import save_variables_npz
from fastspeech2_tpu_torch.cli import synthesize_cli
from fastspeech2_tpu_torch.synthesis.pipeline import Synthesizer
from fastspeech2_tpu_torch.utils.device import resolve_device
from helpers import init_variables, synthetic_batch, tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config", "LJSpeech10")
README_SENTENCE = "The quick brown fox jumps over the lazy dog."
VOCODER = os.path.join(REPO, "weights", "vocoder_gen_mixed60k.npz")


def test_imports_without_jax():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['flax'] = None\n"
            "sys.modules['optax'] = None\n"
            "sys.modules['orbax'] = None\n"
            "sys.modules['fastspeech2_tpu'] = None\n"
            "sys.modules['matplotlib'] = None\n"
            "sys.modules['tensorboardX'] = None\n"
            "import fastspeech2_tpu_torch\n"
            "import fastspeech2_tpu_torch.cli.synthesize_cli\n"
            "import fastspeech2_tpu_torch.cli.train_cli\n"
            "import fastspeech2_tpu_torch.cli.evaluate_cli\n"
            "import fastspeech2_tpu_torch.tools.kernel_bounds\n"
            "import fastspeech2_tpu_torch.tools.profile_train\n"
            "import fastspeech2_tpu_torch.ops.cuda_attention\n"
            "import fastspeech2_tpu_torch.ops.cuda_ffn\n"
            "import fastspeech2_tpu_torch.ops.cuda_resblock\n"
            "import fastspeech2_tpu_torch.models.hifigan\n"
            "import fastspeech2_tpu_torch.synthesis.vocoder\n"
            "import fastspeech2_tpu_torch.tools.repro_train\n"
            "import fastspeech2_tpu_torch.data.dataset\n"
            "import fastspeech2_tpu_torch.data.prefetch\n"
            "import fastspeech2_tpu_torch.data.synthetic\n"
            "import fastspeech2_tpu_torch.models.loss\n"
            "import fastspeech2_tpu_torch.training.checkpoint\n"
            "import fastspeech2_tpu_torch.training.loop\n"
            "import fastspeech2_tpu_torch.training.optim\n"
            "import fastspeech2_tpu_torch.training.step\n"
            "import fastspeech2_tpu_torch.audio.mel\n"
            "import fastspeech2_tpu_torch.audio.stft\n"
            "import fastspeech2_tpu_torch.models.melgan\n"
            "import fastspeech2_tpu_torch.text.pinyin_g2p\n"
            "import fastspeech2_tpu_torch.synthesis.plotting\n"
            "import fastspeech2_tpu_torch.synthesis.pipeline\n"
            "import fastspeech2_tpu_torch.audio.wav\n"
            "import fastspeech2_tpu_torch.audio.dio\n"
            "import fastspeech2_tpu_torch.audio.f0\n"
            "import fastspeech2_tpu_torch.preprocessing.textgrid\n"
            "import fastspeech2_tpu_torch.preprocessing.corpora\n"
            "import fastspeech2_tpu_torch.preprocessing.mfa\n"
            "import fastspeech2_tpu_torch.preprocessing.preprocessor\n"
            "import fastspeech2_tpu_torch.align.features\n"
            "import fastspeech2_tpu_torch.align.aligner\n"
            "import fastspeech2_tpu_torch.align.textgrid_writer\n"
            "import fastspeech2_tpu_torch.cli.preprocess_cli\n"
            "import fastspeech2_tpu_torch.cli.align_cli\n"
            "import fastspeech2_tpu_torch.utils.logging\n"
            "import fastspeech2_tpu_torch.tools.readme_reference\n"
            "import fastspeech2_tpu_torch.models.hifigan_disc\n"
            "import fastspeech2_tpu_torch.training.vocoder\n"
            "import fastspeech2_tpu_torch.cli.train_vocoder_cli\n"
            "import fastspeech2_tpu_torch.cli.export_mels_cli\n"
            "import fastspeech2_tpu_torch.cli.export_cli\n"
            "import fastspeech2_tpu_torch.synthesis.graphs\n"
            "import fastspeech2_tpu_torch.ops.device_cache\n"
            "import fastspeech2_tpu_torch.tools.serve_bench\n"
            "import fastspeech2_tpu_torch.serving\n"
            "import fastspeech2_tpu_torch.serving.server\n"
            "import fastspeech2_tpu_torch.cli.serve_cli\n"
            "import fastspeech2_tpu_torch.evaluation\n"
            "import fastspeech2_tpu_torch.evaluation.metrics\n"
            "import fastspeech2_tpu_torch.evaluation.vocoder_eval\n"
            "import fastspeech2_tpu_torch.evaluation.prosody_sweep\n"
            "import fastspeech2_tpu_torch.evaluation.align_validation\n"
            "import fastspeech2_tpu_torch.evaluation.demo_page\n"
            "import fastspeech2_tpu_torch.parallel\n"
            "import fastspeech2_tpu_torch.parallel.comm\n"
            "import fastspeech2_tpu_torch.parallel.launch\n"
            "import fastspeech2_tpu_torch.parallel.mesh\n"
            "import fastspeech2_tpu_torch.parallel.sharding\n"
            "import fastspeech2_tpu_torch.text.neural_g2p\n"
            "import fastspeech2_tpu_torch.text.train_g2p\n"
            "import fastspeech2_tpu_torch.text.mine_lexicon\n"
            "import fastspeech2_tpu_torch.tools.parallel_steps\n"
            "import fastspeech2_tpu_torch.tools.leave_one_out\n"
            "import fastspeech2_tpu_torch.tools.score_vocoder_ladder\n"
            "import fastspeech2_tpu_torch.tools.g2p_ensemble\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'flax', "
            "'optax', 'orbax', 'fastspeech2_tpu.')) for m in sys.modules "
            "if sys.modules[m])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_never_import_jax():
    pkg = os.path.join(REPO, "fastspeech2_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(pkg):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            for line in f:
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    top = words[1].split(".")[0]
                    assert top not in ("jax", "flax", "optax", "orbax",
                                       "fastspeech2_tpu"), \
                        f"{path}: {line.strip()}"


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synthesize_cli.main([
            "--mode", "single", "--text", "hello",
            "-p", f"{CONFIG}/preprocess.yaml", "-m", f"{CONFIG}/model.yaml",
            "-t", f"{CONFIG}/train.yaml", "--weights_npz", "unused.npz",
            "--vocoder_ckpt", VOCODER])
    assert resolve_device("cpu") == torch.device("cpu")


def _tiny_setup(tmp_path, max_seq_len=64, model_yaml=f"{CONFIG}/model.yaml"):
    """Tiny model.yaml (from ``model_yaml``) + acoustic npz from the JAX
    initialiser, and a train.yaml whose result path is under tmp_path."""
    with open(model_yaml) as f:
        model_cfg = yaml.safe_load(f)
    tr = model_cfg["transformer"]
    tr.update(encoder_layer=1, decoder_layer=2, encoder_hidden=16,
              decoder_hidden=16, conv_filter_size=32)
    model_cfg["variance_predictor"]["filter_size"] = 16
    model_cfg["variance_embedding"]["n_bins"] = 16
    model_cfg["max_seq_len"] = max_seq_len
    model_cfg["postnet"] = {"embedding_dim": 16, "kernel_size": 5,
                            "n_convolutions": 3}
    model_path = tmp_path / "model.yaml"
    model_path.write_text(yaml.safe_dump(model_cfg))

    with open(f"{CONFIG}/train.yaml") as f:
        train_cfg = yaml.safe_load(f)
    train_cfg["path"]["result_path"] = str(tmp_path / "jax_result")
    train_path = tmp_path / "train.yaml"
    train_path.write_text(yaml.safe_dump(train_cfg))

    jax_cfg = tiny_config(encoder_layer=1, decoder_layer=2,
                          n_mel_channels=80, max_seq_len=max_seq_len,
                          postnet_n_convolutions=3)
    variables = dict(init_variables(JaxFastSpeech2(jax_cfg),
                                    synthetic_batch(jax_cfg, seed=4), seed=4))
    params = variables["params"]
    # a few frames per phone, so the utterance has frames to speak
    params["variance_adaptor"]["duration_predictor"]["linear_layer"][
        "Dense_0"]["bias"] = np.asarray([1.0], np.float32)
    npz = tmp_path / "acoustic.npz"
    save_variables_npz(str(npz), variables)
    return str(model_path), str(train_path), str(npz)


def test_cli_wav_matches_jax_cli(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)   # the configs name corpus files from here
    model_path, train_path, npz = _tiny_setup(tmp_path)
    common = ["--mode", "single", "--text", README_SENTENCE,
              "-p", f"{CONFIG}/preprocess.yaml", "-m", model_path,
              "-t", train_path, "--weights_npz", npz,
              "--vocoder_ckpt", VOCODER]
    jax_main(common)
    wavs, out, paths = synthesize_cli.main(
        common + ["--device", "cpu", "--result_path",
                  str(tmp_path / "torch_result")])

    name = README_SENTENCE[:100] + ".wav"
    sr_ref, ref = wavfile.read(tmp_path / "jax_result" / name)
    sr, got = wavfile.read(paths[0])
    assert paths[0] == str(tmp_path / "torch_result" / name)
    assert (sr, got.dtype) == (sr_ref, np.int16) == (22050, np.int16)
    mel_len = int(out.mel_len[0])
    assert mel_len > 0
    assert got.shape == ref.shape == (mel_len * 256,)
    np.testing.assert_array_equal(got, wavs[0])
    assert np.abs(got.astype(np.int32)).max() > 0
    np.testing.assert_allclose(got.astype(np.float64), ref.astype(np.float64),
                               atol=1e-3 * 32768, rtol=0)


def test_cli_parity_hifigan_wav_matches_jax_cli(tmp_path, monkeypatch):
    """config/LJSpeech/model.yaml names the parity HiFi-GAN; its weights are
    the JAX package's random init at full width, written as an npz the way
    scripts/save_weights_npz.py writes one.  On the CPU the port's
    ResBlocks run K4's plain version."""
    from fastspeech2_tpu.models.hifigan import HiFiGANGenerator

    monkeypatch.chdir(REPO)
    model_path, train_path, npz = _tiny_setup(
        tmp_path, model_yaml=os.path.join(REPO, "config", "LJSpeech",
                                          "model.yaml"))
    with open(model_path) as f:
        assert yaml.safe_load(f)["vocoder"]["model"] == "HiFi-GAN"
    gen = HiFiGANGenerator()
    vocoder_npz = str(tmp_path / "vocoder_parity_init.npz")
    save_variables_npz(vocoder_npz, jax.jit(gen.init)(
        jax.random.PRNGKey(0), jax.numpy.zeros((1, 8, 80))))
    common = ["--mode", "single", "--text", README_SENTENCE,
              "-p", f"{CONFIG}/preprocess.yaml", "-m", model_path,
              "-t", train_path, "--weights_npz", npz,
              "--vocoder_ckpt", vocoder_npz]
    jax_main(common)
    wavs, out, paths = synthesize_cli.main(
        common + ["--device", "cpu", "--result_path",
                  str(tmp_path / "torch_result")])

    sr_ref, ref = wavfile.read(tmp_path / "jax_result" /
                               (README_SENTENCE[:100] + ".wav"))
    sr, got = wavfile.read(paths[0])
    mel_len = int(out.mel_len[0])
    assert sr == sr_ref == 22050 and mel_len > 0
    assert got.shape == ref.shape == (mel_len * 256,)
    np.testing.assert_array_equal(got, wavs[0])
    assert np.abs(ref.astype(np.int32)).max() > 0
    np.testing.assert_allclose(got.astype(np.float64), ref.astype(np.float64),
                               atol=1e-3 * 32768, rtol=0)


def test_long_utterance_redispatch_matches_jax(tmp_path, monkeypatch):
    """A predicted length past max_seq_len re-runs the forward at
    round_up(need, 512) frames with the decoder untruncated, in both
    packages (fastspeech2_tpu/synthesis/pipeline.py:284-326)."""
    monkeypatch.chdir(REPO)
    model_path, train_path, npz = _tiny_setup(tmp_path, max_seq_len=32)
    configs = load_yaml_configs(f"{CONFIG}/preprocess.yaml", model_path,
                                train_path)
    jax_model, variables, jax_cfg = load_model_for_inference(
        configs, weights_npz=npz)
    ref_synth = JaxSynthesizer(jax_model, variables, jax_cfg, configs[0],
                               control_mode="absolute")
    ids, _ = ref_synth.text_to_ids(README_SENTENCE)
    ref = ref_synth.infer_ids([ids], p_control=1.2, e_control=0.8,
                              d_control=1.1)

    model, cfg = synthesize_cli.load_model_for_inference(
        configs[0], configs[1], npz, "cpu")
    synth = Synthesizer(model, cfg, configs[0], "cpu",
                        control_mode="absolute")
    got_ids, _ = synth.text_to_ids(README_SENTENCE)
    np.testing.assert_array_equal(got_ids, ids)
    got = synth.infer_ids([got_ids], p_control=1.2, e_control=0.8,
                          d_control=1.1)
    np.testing.assert_array_equal(got.duration_rounded.numpy(),
                                  np.asarray(ref.duration_rounded))
    assert int(got.duration_rounded.sum()) > 32
    assert got.postnet_mel.shape == (1, 512, 80)
    np.testing.assert_array_equal(got.mel_len.numpy(), np.asarray(ref.mel_len))
    np.testing.assert_allclose(got.postnet_mel.numpy(),
                               np.asarray(ref.postnet_mel), atol=1e-4, rtol=0)
