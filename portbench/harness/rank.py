"""One rank of a multi-chip run: ``python portbench/harness/rank.py
'<spec as JSON>'``. Started by ``launch.execute``; rank 0 prints its
output as the last line of its standard output."""

import json
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from portbench.harness import launch

    out = launch.rank_main(json.loads(sys.argv[1]))
    if out is not None:
        print(json.dumps(out), flush=True)
