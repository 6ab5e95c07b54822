import sys

from polardecoding_tpu_torch.studies import main

if __name__ == "__main__":
    sys.exit(main())
