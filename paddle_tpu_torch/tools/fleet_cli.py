"""Fleet metric aggregation CLI ("pfleet") — thin entry point over
`paddle_tpu_torch.obs.fleet` (the module itself is imported by the obs
package, so `-m` must target this wrapper to avoid the runpy
double-import).  Counterpart of paddle_tpu/tools/fleet_cli.py.

    # worker: publish this process's registry snapshot
    python -m paddle_tpu_torch.tools.fleet_cli --push \
        --master 127.0.0.1:7164

    # operator: the merged host-labeled view + straggler report
    python -m paddle_tpu_torch.tools.fleet_cli --aggregate \
        --master 127.0.0.1:7164

Neither needs a card: the snapshots are the process's metric registry.
"""

import sys

from ..obs.fleet import main

if __name__ == "__main__":
    sys.exit(main())
