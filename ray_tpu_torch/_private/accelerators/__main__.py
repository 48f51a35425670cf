"""Print this host's card advertisement as JSON, for a node of the runtime:

    ray-tpu start --head --resources "$(python -m ray_tpu_torch._private.accelerators)"

The resources are `node_advertisement()`'s: `GPU` and the typed
`GPU-<part>` for the cards of this process's allotment
(CUDA_VISIBLE_DEVICES), read by a probe process; {} on a host without
cards. `--labels` prints the labels instead. A probe that crashes or times
out fails the command.
"""

from __future__ import annotations

import argparse
import json

from ray_tpu_torch._private.accelerators.nvidia import node_advertisement


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--labels", action="store_true",
                        help="print the node's labels, not its resources")
    args = parser.parse_args(argv)
    resources, labels = node_advertisement()
    print(json.dumps(labels if args.labels else resources))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
