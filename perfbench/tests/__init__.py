"""CPU tests of the benchmark harness (``python -m pytest perfbench/tests``);
the ``gpu`` ones run on the card (``-m gpu``)."""
