"""PyTorch / CUDA port of ``ffmpc_tpu``: Franka force-feedback MPC engine.

Same directory layout as the JAX package (``core/``, ``tasks/``, ``ocp/``,
``mpc/``, ``solver/``, ``sim/``, ``run/``, ``tools/``); every function takes
leading batch dimensions natively and every constructor takes an explicit
``device`` and ``dtype``.  Imports ``torch`` and numpy only.
"""
