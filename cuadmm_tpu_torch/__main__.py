import sys

from cuadmm_tpu_torch.cli import main

sys.exit(main())
