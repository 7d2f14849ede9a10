"""Train a ~100M-parameter LM for a few hundred steps (loss must drop).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--device cuda]
"""

import argparse

from repro_torch.launch import train


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument(
        "--big", action="store_true",
        help="~130M-param configuration (for the card; the default is an "
        "8.7M reduced variant that a CPU trains in minutes)",
    )
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.big:
        result = train.run(
            args.arch, steps=args.steps, batch=32, seq=1024,
            reduced=True, lr=3e-4, big=True, device=args.device,
        )
    else:
        result = train.run(
            args.arch, steps=args.steps, batch=8, seq=256, reduced=True, lr=6e-4,
            device=args.device,
        )
    print(f"\narch={result['arch']} params={result['params'] / 1e6:.1f}M")
    print(f"loss {result['first_loss']:.3f} -> {result['final_loss']:.3f} "
          f"({'improved' if result['improved'] else 'NO IMPROVEMENT'})")


if __name__ == "__main__":
    main()
