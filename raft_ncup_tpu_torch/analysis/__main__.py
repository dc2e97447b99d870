"""``python -m raft_ncup_tpu_torch.analysis`` — the port's lint CLI."""

import sys

from raft_ncup_tpu_torch.analysis.lint import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
