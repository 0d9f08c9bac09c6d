"""`python -m kubernetes_tpu_torch.cli ...` — kubectl verbs, plus `cluster up`."""

import sys

from ..cli.cluster import cluster_main
from ..cli.kubectl import main

if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "cluster":
        sys.exit(cluster_main(sys.argv[2:]))
    sys.exit(main())
