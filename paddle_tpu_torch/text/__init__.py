"""Text models of the port (counterpart of paddle_tpu.text).  The dataset
classes of the JAX package's ``text.datasets`` wait for the data slice."""
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
