"""SLIC superpixels on the device, with the Lloyd loop as a CUDA kernel."""
