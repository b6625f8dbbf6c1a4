import sys

from tpuao_torch.cli import main

sys.exit(main())
