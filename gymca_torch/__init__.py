"""gymca_torch — the cellular-automata RL environments of ``gymca_tpu``, ported
to PyTorch and CUDA for an NVIDIA H100.  ``gymca_tpu`` is the reference; this
package imports none of it."""
