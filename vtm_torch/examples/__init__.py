"""Example scripts of the PyTorch package (run with python -m): the
counterparts of ``examples/*.py``. Each runs on the first CUDA device;
``main(argv, device="cpu")`` is for tests."""
