import sys

from portbench.run import main

sys.exit(main())
