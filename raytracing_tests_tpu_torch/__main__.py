from raytracing_tests_tpu_torch.app.cli import main

if __name__ == "__main__":
    main()
