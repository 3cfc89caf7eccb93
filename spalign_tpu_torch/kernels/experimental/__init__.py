"""Experimental device ops, off the production path (counterpart of
``spalign_tpu/kernels/experimental``): ``ccl``, connected components and
fragment absorption in plain torch.  Nothing in production imports them.
"""
