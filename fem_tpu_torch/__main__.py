from fem_tpu_torch.pipeline.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
