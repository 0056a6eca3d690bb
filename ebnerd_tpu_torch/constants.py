"""EB-NeRD schema column names used by the port (copy of the subset of
``ebnerd_tpu/constants.py`` that the serving slice reads). The values are
the dataset's public parquet column names."""

DEFAULT_IMPRESSION_ID_COL = "impression_id"
DEFAULT_ARTICLE_ID_COL = "article_id"
DEFAULT_INVIEW_ARTICLES_COL = "article_ids_inview"
DEFAULT_USER_COL = "user_id"
DEFAULT_HISTORY_ARTICLE_ID_COL = "article_id_fixed"
DEFAULT_TITLE_COL = "title"
DEFAULT_LABELS_COL = "labels"
