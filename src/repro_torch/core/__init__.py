"""The paper's system on PyTorch: primitives, costs, PBQP selection, plans.

``scenario``, ``layouts``, ``winograd_transforms``, ``ioutil``, ``pbqp``,
``choice_space`` and ``selection`` are verbatim copies of the reference's
JAX-free modules (tests/test_torch_imports.py holds them byte-identical);
``primitives``, ``graph``, ``costs`` and ``plan`` are ports.
"""
