"""The native host runtime: corpus BLEU counting and the batch gather in C++,
built with g++ on first use (``lib.py``)."""
