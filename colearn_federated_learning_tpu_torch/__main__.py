import sys

from colearn_federated_learning_tpu_torch.cli import main

sys.exit(main())
