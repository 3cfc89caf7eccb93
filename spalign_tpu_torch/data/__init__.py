"""Datasets for the port (numpy, no cv2)."""
