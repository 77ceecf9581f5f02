import sys

from cruise_control_tpu_torch.fuzzsvc.runner import main

if __name__ == "__main__":
    sys.exit(main())
