"""Batched serving with the PyTorch port: decode a batch of requests
with a KV cache. Runs on the card unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]
"""
import argparse

from repro_torch.launch import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    args = argparse.Namespace(arch="qwen2-1.5b", reduced=True, batch=8,
                              prompt_len=16, gen=32, device=a.device)
    out = serve.run(args)
    assert len(out) == args.gen
    print("OK")


if __name__ == "__main__":
    main()
