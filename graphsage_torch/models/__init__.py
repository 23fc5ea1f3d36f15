from graphsage_torch.models.graphsage import (
    Frontier,
    GraphSageConfig,
    graphsage_apply,
    graphsage_apply_gathered,
    init_graphsage,
)
from graphsage_torch.models.layers import (
    Classifier,
    GraphSage,
    SageLayer,
    classifier_apply,
    init_classifier,
    init_sage_layer,
    mean_pretransform,
    sage_layer_apply,
    xavier_uniform,
)
from graphsage_torch.models.lstm_agg import (
    LSTMAggregator,
    init_lstm_agg,
    lstm_aggregate,
    lstm_scan,
)

__all__ = [
    "Classifier",
    "Frontier",
    "GraphSage",
    "GraphSageConfig",
    "LSTMAggregator",
    "SageLayer",
    "classifier_apply",
    "graphsage_apply",
    "graphsage_apply_gathered",
    "init_classifier",
    "init_graphsage",
    "init_lstm_agg",
    "init_sage_layer",
    "lstm_aggregate",
    "lstm_scan",
    "mean_pretransform",
    "sage_layer_apply",
    "xavier_uniform",
]
