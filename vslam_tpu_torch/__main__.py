"""python -m vslam_tpu_torch <run|eval|convert|bench> ... (system/cli.py)."""

from vslam_tpu_torch.system.cli import main

if __name__ == "__main__":
    main()
