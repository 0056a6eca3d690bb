"""Host data layer of the port: ragged columns, tables, id lookups, the
behaviors and history transforms, article features, the synthetic split
and the training and eval feeds (numpy only; copies of the matching
``ebnerd_tpu.data`` modules)."""
from .articles import (
    VocabTokenizer,
    build_token_lookup,
    build_value_lookup,
    concat_str_columns,
    convert_text2encoding_with_transformers,
    create_article_id_to_value_mapping,
    create_sort_based_prediction_score,
    load_article_id_embeddings,
)
from .behaviors import (
    add_known_user_column,
    add_prediction_scores,
    create_binary_labels_column,
    create_user_id_to_int_mapping,
    down_sample_on_users,
    ebnerd_from_path,
    ebnerd_from_tables,
    filter_minimum_negative_samples,
    join_history,
    remove_positives_from_inview,
    sample_article_ids,
    sampling_strategy_wu2019,
    truncate_history,
    unique_article_ids_in_behaviors,
)
from .dataloader import EvalFeed, NewsrecFeed, pad_to_multiple
from .lookup import Lookup, create_lookup_objects
from .ragged import Ragged
from .synthetic import make_synthetic_ebnerd, synthetic_ebnerd_tables
from .table import Table, read_parquet, write_parquet

__all__ = ["EvalFeed", "NewsrecFeed", "Lookup", "Ragged", "Table", "VocabTokenizer",
           "add_known_user_column", "add_prediction_scores", "build_token_lookup",
           "build_value_lookup", "concat_str_columns", "convert_text2encoding_with_transformers",
           "create_article_id_to_value_mapping", "create_binary_labels_column",
           "create_lookup_objects", "create_sort_based_prediction_score",
           "create_user_id_to_int_mapping", "down_sample_on_users", "ebnerd_from_path",
           "ebnerd_from_tables", "filter_minimum_negative_samples", "join_history",
           "load_article_id_embeddings", "make_synthetic_ebnerd", "pad_to_multiple",
           "read_parquet", "remove_positives_from_inview", "sample_article_ids",
           "sampling_strategy_wu2019", "synthetic_ebnerd_tables", "truncate_history",
           "unique_article_ids_in_behaviors", "write_parquet"]
