"""CLI for the batched TTS HTTP server (port of
``fastspeech2_tpu/cli/serve_cli.py``):

    python -m fastspeech2_tpu_torch.cli.serve_cli \\
        -p config/LJSpeech10/preprocess.yaml \\
        -m config/LJSpeech10/model.yaml -t config/LJSpeech10/train.yaml \\
        --weights_npz weights/acoustic_LJSpeech10_100k.npz \\
        --vocoder_ckpt weights/vocoder_gen_mixed60k.npz \\
        [--port 8000] [--max_batch_size 16] [--max_wait_ms 20] \\
        [--device cuda|cpu]

Then:  curl -X POST localhost:8000/synthesize \\
         -d '{"text": "hello world"}' -o out.wav

Runs on the card unless ``--device cpu`` is given.  Before taking traffic
it makes the top (batch bucket x text bucket) shape warm (on the card:
captures its CUDA graph; ``--warmup_grid`` for the rest of the grid,
``--no_warmup`` for none).  ``--data_parallel N`` serves with one model
replica on each of ``cuda:0`` ... ``cuda:N-1``, in this one process
(``synthesis/pipeline.py``); it raises where fewer cards are visible, or
with ``--device cpu``.
"""

import argparse
import os

import torch

from fastspeech2_tpu_torch.cli.common import add_dtype_arg, dtype_from_flag
from fastspeech2_tpu_torch.cli.synthesize_cli import (
    add_weights_args,
    load_model_for_inference,
)
from fastspeech2_tpu_torch.configs.config import load_yaml_configs
from fastspeech2_tpu_torch.serving import BatchingSynthesizer, TTSServer
from fastspeech2_tpu_torch.synthesis.pipeline import Synthesizer
from fastspeech2_tpu_torch.synthesis.vocoder import get_vocoder
from fastspeech2_tpu_torch.utils.device import resolve_device


def build_server(args):
    """-> a TTSServer (not started) over a BatchingSynthesizer over a
    snapping Synthesizer with the weights and vocoder ``args`` name."""
    device = resolve_device(args.device)
    devices = None
    if args.data_parallel and args.data_parallel > 1:
        n = args.data_parallel
        visible = torch.cuda.device_count() if device.type == "cuda" else 0
        if visible < n:
            raise ValueError(f"--data_parallel {n} needs {n} cards, "
                             f"{visible} visible on {device.type}")
        devices = [torch.device(f"cuda:{i}") for i in range(n)]
        device = devices[0]
    preprocess_config, model_config, train_config = load_yaml_configs(
        args.preprocess_config, args.model_config, args.train_config)
    model, cfg = load_model_for_inference(
        preprocess_config, model_config, args.weights_npz, device,
        train_config=train_config, restore_step=args.restore_step,
        torch_ckpt=args.torch_ckpt, dtype=dtype_from_flag(args.dtype))
    vocoder = get_vocoder(model_config, preprocess_config, args.vocoder_ckpt,
                          device)
    synthesizer = Synthesizer(model, cfg, preprocess_config, device,
                              vocoder=vocoder, snap_to_warm=True,
                              devices=devices)
    batcher = BatchingSynthesizer(
        synthesizer, max_batch_size=args.max_batch_size,
        max_wait_ms=args.max_wait_ms, max_pending=args.max_pending)
    sr = preprocess_config["preprocessing"]["audio"]["sampling_rate"]
    token = args.auth_token or os.environ.get("TTS_AUTH_TOKEN") or None
    return TTSServer(batcher, sr, host=args.host, port=args.port,
                     auth_token=token, max_body_bytes=args.max_body_bytes,
                     max_text_len=args.max_text_len)


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-p", "--preprocess_config", required=True)
    parser.add_argument("-m", "--model_config", required=True)
    parser.add_argument("-t", "--train_config", required=True)
    add_weights_args(parser)
    parser.add_argument("--vocoder_ckpt", default=None,
                        help="vocoder weights (npz or .pth.tar)")
    add_dtype_arg(parser, "float32")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max_batch_size", type=int, default=16)
    parser.add_argument("--max_wait_ms", type=float, default=20.0)
    parser.add_argument("--max_pending", type=int, default=256,
                        help="in-flight request cap; excess is shed "
                             "with HTTP 429")
    parser.add_argument("--auth_token", default=None,
                        help="require 'Authorization: Bearer <token>' "
                             "on POSTs (default: $TTS_AUTH_TOKEN if set)")
    parser.add_argument("--max_body_bytes", type=int, default=65536)
    parser.add_argument("--max_text_len", type=int, default=4096)
    parser.add_argument("--no_warmup", action="store_true",
                        help="make no shape warm at startup (no CUDA "
                             "graph: every request runs eagerly)")
    parser.add_argument("--warmup_grid", default="top",
                        choices=["top", "background", "full"],
                        help="beyond the always-warmed top shape: 'top' "
                             "warms nothing else (requests snap to it), "
                             "'background' fills the grid in a thread, "
                             "'full' fills it blocking before traffic")
    parser.add_argument("--data_parallel", type=int, default=None,
                        help="one model replica on each of N cards; each "
                             "dispatch's rows split over them")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    server = build_server(args)
    if not args.no_warmup:
        server.batcher.warmup(grid=args.warmup_grid)
    print(f"Serving TTS on {args.host}:{server.port} "
          f"(max_batch_size={args.max_batch_size}, "
          f"max_wait_ms={args.max_wait_ms})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
