"""Forward-plugin templates of the PyTorch port (``myfwd.py``)."""
