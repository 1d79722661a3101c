"""Result datasets of the port: the copies of ``spgrid/viz/dataset.py``'s
functions that the dispatch study reads, on ``csv`` and numpy."""
