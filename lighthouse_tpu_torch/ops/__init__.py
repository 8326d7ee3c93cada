"""Device ops of the port: constants and codecs (fp.py), lane-major kernels (lane/)."""
