"""EB-NeRD schema column names (copy of ``ebnerd_tpu/constants.py``). The
values are the dataset's public parquet column names, so they must match
the dataset exactly.
"""

# --- behaviors.parquet -----------------------------------------------------
DEFAULT_IMPRESSION_ID_COL = "impression_id"
DEFAULT_ARTICLE_ID_COL = "article_id"
DEFAULT_IMPRESSION_TIMESTAMP_COL = "impression_time"
DEFAULT_READ_TIME_COL = "read_time"
DEFAULT_SCROLL_PERCENTAGE_COL = "scroll_percentage"
DEFAULT_DEVICE_COL = "device_type"
DEFAULT_INVIEW_ARTICLES_COL = "article_ids_inview"
DEFAULT_CLICKED_ARTICLES_COL = "article_ids_clicked"
DEFAULT_USER_COL = "user_id"
DEFAULT_IS_SSO_USER_COL = "is_sso_user"
DEFAULT_GENDER_COL = "gender"
DEFAULT_POSTCODE_COL = "postcode"
DEFAULT_AGE_COL = "age"
DEFAULT_IS_SUBSCRIBER_COL = "is_subscriber"
DEFAULT_SESSION_ID_COL = "session_id"
DEFAULT_NEXT_READ_TIME_COL = "next_read_time"
DEFAULT_NEXT_SCROLL_PERCENTAGE_COL = "next_scroll_percentage"
DEFAULT_IS_BEYOND_ACCURACY_COL = "is_beyond_accuracy"

# --- history.parquet -------------------------------------------------------
DEFAULT_HISTORY_IMPRESSION_TIMESTAMP_COL = "impression_time_fixed"
DEFAULT_HISTORY_SCROLL_PERCENTAGE_COL = "scroll_percentage_fixed"
DEFAULT_HISTORY_ARTICLE_ID_COL = "article_id_fixed"
DEFAULT_HISTORY_READ_TIME_COL = "read_time_fixed"

# --- articles.parquet ------------------------------------------------------
DEFAULT_TITLE_COL = "title"
DEFAULT_SUBTITLE_COL = "subtitle"
DEFAULT_BODY_COL = "body"
DEFAULT_CATEGORY_COL = "category"
DEFAULT_CATEGORY_STR_COL = "category_str"
DEFAULT_SUBCATEGORY_COL = "subcategory"
DEFAULT_ARTICLE_TYPE_COL = "article_type"
DEFAULT_ARTICLE_MODIFIED_TIMESTAMP_COL = "last_modified_time"
DEFAULT_ARTICLE_PUBLISHED_TIMESTAMP_COL = "published_time"
DEFAULT_SENTIMENT_SCORE_COL = "sentiment_score"
DEFAULT_SENTIMENT_LABEL_COL = "sentiment_label"
DEFAULT_ENTITIES_COL = "entity_groups"
DEFAULT_NER_COL = "ner_clusters"
DEFAULT_IMAGE_IDS_COL = "image_ids"
DEFAULT_TOPICS_COL = "topics"
DEFAULT_TOTAL_INVIEWS_COL = "total_inviews"
DEFAULT_TOTAL_PAGEVIEWS_COL = "total_pageviews"
DEFAULT_TOTAL_READ_TIME_COL = "total_read_time"
DEFAULT_URL_COL = "url"

# --- derived columns -------------------------------------------------------
DEFAULT_KNOWN_USER_COL = "is_known_user"
DEFAULT_LABELS_COL = "labels"
