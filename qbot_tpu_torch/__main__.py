"""python -m qbot_tpu_torch FILE — module entry point."""
from qbot_tpu_torch import main

if __name__ == "__main__":
    main()
