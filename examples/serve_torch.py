"""Example: continuous-batching TTS serving with the PyTorch port's
DecodeServer.

With random weights this produces noise-token streams -- it demonstrates
the serving flow (queue -> slots -> chunked decode -> completions). Point
--lina-ckpt at a reference-named torch state_dict for real use. Runs on
the GPU unless --cpu is given.

  python examples/serve_torch.py --requests 6 --slots 2 --cpu
  python examples/serve_torch.py --cpu --lazy --chunk 4 --weight-quant int8 --state-quant int8
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--requests", type=int, default=6)
    p.add_argument("--slots", type=int, default=2)
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--max-len", type=int, default=64)
    p.add_argument("--config", default=None, help="model YAML (default tiny)")
    p.add_argument("--lina-ckpt", default=None,
                   help="torch state_dict with the reference's parameter names")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--lazy", action="store_true",
                   help="lazy-window decode (chunk == lazy window; for high "
                        "slot occupancy, GLA backbones)")
    p.add_argument("--weight-quant", choices=["int8"], default=None,
                   help="decode on int8 copies of the large weights (prefill "
                        "and text encoding stay at full precision)")
    p.add_argument("--state-quant", choices=["int8"], default=None,
                   help="int8 base states with per-row scales (needs --lazy)")
    p.add_argument("--quant-min-size", type=int, default=None,
                   help="least element count of a weight that is quantized "
                        "(default: 65536, or 256 for the tiny config)")
    args = p.parse_args()

    import numpy as np
    import torch

    from lina_speech_tpu_torch.config import build_model, lina_gla_tiny, load_config
    from lina_speech_tpu_torch.serving import DecodeServer
    from lina_speech_tpu_torch.data.tokenizer import ByteTokenizer

    cfg = load_config(args.config)["model"] if args.config else lina_gla_tiny()
    model = build_model(cfg, device="cpu" if args.cpu else None, seed=2).eval()
    tok = ByteTokenizer()

    if args.lina_ckpt:
        sd = torch.load(os.path.abspath(args.lina_ckpt), map_location="cpu")
        sd = {k.removeprefix("model."): v for k, v in sd.get("state_dict", sd).items()}
        model.load_state_dict(sd, strict=False)

    texts = [f"hello stream number {i} from the gpu" for i in range(args.requests)]
    min_size = args.quant_min_size or (1 << 16 if args.config else 1 << 8)
    srv = DecodeServer(model, n_slots=args.slots, max_text_len=64,
                       chunk=args.chunk, lazy=args.lazy,
                       weight_quant=args.weight_quant, quant_min_size=min_size,
                       state_quant=args.state_quant)
    t0 = time.perf_counter()
    for t in texts:
        srv.submit(np.asarray(tok.encode(t)), max_len=args.max_len)
    done = srv.run()
    dt = time.perf_counter() - t0
    total = sum(c.length for c in done)
    print(f"{len(done)} requests, {total} tokens in {dt:.2f}s "
          f"({total / dt:.0f} tok/s aggregate) on {args.slots} slots, "
          f"device {srv.device}")
    for c in done:
        print(f"  rid={c.rid} len={c.length} stopped={c.stopped}")


if __name__ == "__main__":
    main()
