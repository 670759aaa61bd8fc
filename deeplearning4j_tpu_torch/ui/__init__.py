"""Observability tier: stats collection, storage, dashboard (reference
deeplearning4j-ui-parent). Counterpart of ``deeplearning4j_tpu/ui``, with
its ``__all__``."""
from .components import (ChartHistogram, ChartHorizontalBar, ChartLine,
                         ChartScatter, ChartStackedArea, ChartTimeline,
                         Component, ComponentDiv, ComponentTable,
                         ComponentText, DecoratorAccordion, render_html,
                         training_report)
from .components import from_json as component_from_json
from .dashboard import TrainingUIServer, render_dashboard, render_dashboard_html
from .stats import StatsListener, StatsUpdateConfiguration
from .storage import (FileStatsStorage, InMemoryStatsStorage,
                      SqliteStatsStorage, StatsStorage,
                      StatsStorageEvent)
from .visual import (ConvolutionalIterationListener, activation_grid_png,
                     render_model_graph, render_model_graph_svg,
                     render_tsne, render_tsne_page)

__all__ = [
    "StatsListener", "StatsUpdateConfiguration", "StatsStorage",
    "InMemoryStatsStorage", "FileStatsStorage", "SqliteStatsStorage",
    "StatsStorageEvent",
    "render_dashboard", "render_dashboard_html", "TrainingUIServer",
    "ConvolutionalIterationListener", "activation_grid_png",
    "render_model_graph", "render_model_graph_svg", "render_tsne",
    "render_tsne_page",
    "Component", "ComponentDiv", "ComponentTable", "ComponentText",
    "ChartLine", "ChartScatter", "ChartHistogram", "ChartHorizontalBar",
    "ChartStackedArea", "ChartTimeline", "DecoratorAccordion",
    "render_html", "component_from_json", "training_report",
]
