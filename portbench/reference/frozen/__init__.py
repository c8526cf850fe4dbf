"""A frozen copy of the port's analysis as plain PyTorch: the modules of
``pywindow_torch`` (``config``, ``tables``, ``io/forcefield``, and of
``ops``: ``encoding``, ``geometry``, ``rays``, ``ray_kernels``,
``cluster``, ``lbfgsb``, ``lbfgsb_kernels``, ``nm_kernels``, ``optim``,
``windows``, ``analysis``) as the port held them when the benchmark was
defined, with the CUDA wrappers, the CPU mirrors of the kernels and the
float64 "classic" optimiser paths left out: every kernel entry point
runs its plain version, and the optimisers always run the card's stable
drivers.  The docstrings are the originals'; where one names a CUDA
wrapper, that wrapper is not here.  Nothing here imports the program,
so a later change to it does not move the reference.
"""
