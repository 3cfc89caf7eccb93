"""Label generation on the fused-SLIC path and the image wire."""
