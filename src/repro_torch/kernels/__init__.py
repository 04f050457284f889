"""Fused-operator execution: the torch-eager oracle and the Hopper kernels.

``ref.py`` is the torch-eager oracle every kernel is held against;
``cuda_src.py`` generates one CUDA C++ source per CPlan over the template
skeletons in ``csrc/`` (``cell.cuh``, ``magg.cuh``, ``row.cuh``,
``outer.cuh``); ``build.py`` compiles them with ``nvcc`` at first use and
launches them; ``cellwise.py`` / ``multiagg.py`` / ``rowwise.py`` /
``outerprod.py`` are the kernel wrappers with their plain versions;
``blocksparse.py`` holds the BCSR format; ``ops.py`` is the dispatch.
Importing this package needs neither ``nvcc`` nor a card.
"""
