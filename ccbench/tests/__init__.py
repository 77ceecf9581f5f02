"""CPU tests of the benchmark (``python -m pytest ccbench/tests``); the one marked ``cuda`` runs on the card."""
