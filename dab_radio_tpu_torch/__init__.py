"""dab_radio_tpu_torch — the DAB receiver in PyTorch, with CUDA kernels for
NVIDIA Hopper.

A port of the JAX package ``dab_radio_tpu``, which stays beside it as the
reference: every module here mirrors its counterpart's path (``ops/``,
``models/``, ``dab/``, ``apps/``, ``utils/``), and ``tests/test_torch_*.py``
hold each one against it on the same inputs. The host byte layers
(parameter tables, FIG parser, ensemble database, superframes, RS/CRC,
codecs, IO) are numpy and ctypes copies of their counterparts, so this
package imports nothing of ``dab_radio_tpu``.

Tensors live on an explicit ``torch.device`` that the app passes down
(``utils/backend.py``). Hand-written kernels are in ``csrc/`` with their
wrappers in ``kernels/``: a wrapper launches its kernel for a CUDA tensor and
runs the kernel's plain PyTorch version only for a CPU tensor. This package
never imports ``jax``.
"""

__version__ = "0.1.0"
