"""The host's native component: the libjpeg decoder with the exact resize
and crop (``decode.cpp``, a copy of the JAX package's), built at first use
(``build.py``) and bound with ctypes (``decoder.py``)."""
