import sys

from tpuimg_torch.cli import main

sys.exit(main())
