"""Multi-device routing.  Only the single-device outcome is ported
(qdist.py); the mesh kernels wait for ROADMAP.md module 9."""
