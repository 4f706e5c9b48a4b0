"""The port's native host runtime: TEXMEX reader/writer and the k-way
result merger, C++ compiled with g++ at first use (``build.py``)."""
