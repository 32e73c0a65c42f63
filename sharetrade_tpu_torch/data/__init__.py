"""Market data: price series types, CSV loader, synthetic series, service."""

from sharetrade_tpu_torch.data.ingest import PriceSeries, load_price_csv  # noqa: F401
from sharetrade_tpu_torch.data.service import PriceDataService  # noqa: F401
from sharetrade_tpu_torch.data.synthetic import synthetic_price_series  # noqa: F401
