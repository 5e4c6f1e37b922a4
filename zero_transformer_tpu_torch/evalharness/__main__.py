from zero_transformer_tpu_torch.evalharness.cli import main

if __name__ == "__main__":
    main()
