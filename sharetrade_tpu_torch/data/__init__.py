"""Market data: price series types, CSV loader, synthetic series, the
event journal and the price data service."""

from sharetrade_tpu_torch.data.ingest import PriceSeries, load_price_csv, parse_price_lines  # noqa: F401
from sharetrade_tpu_torch.data.journal import Journal  # noqa: F401
from sharetrade_tpu_torch.data.service import PriceDataService, StockDataResponse  # noqa: F401
from sharetrade_tpu_torch.data.synthetic import synthetic_price_series  # noqa: F401
