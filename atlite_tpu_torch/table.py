"""A small table of named columns, the port's stand-in for the pandas
Series and DataFrame that the JAX Cutout returns (``available_features``,
``prepared_features``, ``grid``).  ``to_pandas()`` builds the pandas
object, and imports pandas only then.
"""

from __future__ import annotations


class Table:
    """Columns of equal length, with an optional row index.

    A feature table (``series=True``) has one column, ``variable``, and
    (module, feature) rows, as the JAX Series has its MultiIndex; its
    ``values`` are that column.  The grid table has the columns x, y and
    geometry, rows numbered from 0.
    """

    __slots__ = ("columns", "index", "index_names", "series")

    def __init__(self, columns, index=None, index_names=None, series=False):
        self.columns = dict(columns)
        n = len(next(iter(self.columns.values()))) if self.columns else 0
        if any(len(v) != n for v in self.columns.values()):
            raise ValueError("columns differ in length")
        self.index = list(range(n)) if index is None else list(index)
        if len(self.index) != n:
            raise ValueError("index and columns differ in length")
        self.index_names = None if index_names is None else list(index_names)
        self.series = series

    def __len__(self):
        return len(self.index)

    def __getitem__(self, column):
        return self.columns[column]

    @property
    def values(self):
        """The one column of a feature table."""
        (col,) = self.columns.values()
        return col

    def rows(self):
        """(index, *column values) of every row, in order."""
        return [(i, *vals) for i, *vals in zip(self.index, *self.columns.values())]

    def __repr__(self):
        head = ", ".join(self.columns)
        return f"<atlite_tpu_torch.Table ({len(self)} rows: {head})>"

    def to_pandas(self):
        """The pandas Series (feature table) or DataFrame; imports pandas."""
        import pandas as pd

        if self.index_names is not None and len(self.index_names) > 1:
            index = pd.MultiIndex.from_tuples(self.index, names=self.index_names)
        else:
            index = pd.RangeIndex(len(self)) if self.index == list(range(len(self))) \
                else pd.Index(self.index, name=(self.index_names or [None])[0])
        if self.series:
            return pd.Series(self.values, index, dtype=object)
        return pd.DataFrame(self.columns, index=index)
