import sys

from portbench.harness import main

sys.exit(main(sys.argv[1:]))
