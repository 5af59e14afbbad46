"""Text models and datasets of the port (counterpart of paddle_tpu.text)."""
from .datasets import (Conll05st, Imdb, Imikolov, Movielens,
                       MovieReviews, UCIHousing, WMT14, WMT16)
from .ernie import (
    BertConfig,
    BertForPretraining,
    BertModel,
    ErnieConfig,
    ErnieForPretraining,
    ErnieForSequenceClassification,
    ErnieModel,
    ErniePretrainingCriterion,
)
