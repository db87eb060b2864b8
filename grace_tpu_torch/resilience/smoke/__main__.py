"""``python -m grace_tpu_torch.resilience.smoke``: the chaos drills on the
port (:mod:`grace_tpu_torch.resilience.smoke.cli`)."""

import sys

from grace_tpu_torch.resilience.smoke.cli import main

if __name__ == "__main__":
    sys.exit(main())
