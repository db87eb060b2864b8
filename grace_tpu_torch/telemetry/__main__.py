"""``python -m grace_tpu_torch.telemetry PATH [--metrics a,b] [--json]``:
the report of one telemetry run log (:mod:`.report`)."""

import sys

from grace_tpu_torch.telemetry.report import main

if __name__ == "__main__":
    sys.exit(main())
