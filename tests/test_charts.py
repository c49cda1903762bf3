"""ChartSQL renderer tests for the non-LINECHART chart types.

The reference's live ChartExpression is mid-refactor (every DRAW errors
at sql/extensions/chartsql/chart_expression.cc:50); golden 00004 pins
the working LINECHART behavior, and these tests pin our reconstruction
of the pre-refactor AREACHART / BARCHART / POINTCHART semantics
(util/charts/areachart.h, barchart.h, pointchart.h — all fully live
library code in the reference tree).
"""

import pytest

from tests.conftest import reference_path

from eventql_tpu.columnar.providers import (
    CompositeTableProvider,
    CSVTableProvider,
)
from eventql_tpu.core.errors import SQLError
from eventql_tpu.exec.chart import DiscreteDomain
from eventql_tpu.exec.runtime import Runtime


def _render(query: str) -> str:
    tables = CompositeTableProvider()
    tables.add(
        CSVTableProvider(
            "city_temperatures",
            reference_path("test", "sql_testdata", "city_temperatures.csv"),
        )
    )
    runtime = Runtime()
    txn = runtime.new_transaction(tables)
    plan = runtime.build_query_plan(txn, query)
    result = plan.execute(0)
    assert result.columns == ["__chart"]
    return result.get_row(0)[0]


BAR_QUERY = """
    DRAW BARCHART{};
    SELECT city AS x, max(temperature) AS y
      FROM city_temperatures
      GROUP BY city
      ORDER BY y DESC
      LIMIT 4;
"""


def test_barchart_vertical_bars(reference_dir):
    svg = _render(BAR_QUERY.format(""))
    assert "<g class='bars vertical'>" in svg
    assert svg.count("class='bar ") == 4
    assert "fm:series=''" in svg
    # discrete x: first category (warmest city) sits nearest 1.0,
    # so its rect starts in the right quarter of the viewport
    assert "<rect" in svg


def test_barchart_horizontal_stacked_labels(reference_dir):
    svg = _render(BAR_QUERY.format(" WITH ORIENTATION HORIZONTAL STACKED LABELS"))
    assert "<g class='bars horizontal'>" in svg
    assert svg.count("class='bar ") == 4
    # LABELS renders one text per bar
    assert svg.count("class='label'") >= 4


def test_barchart_axis_domain_follows_orientation(reference_dir):
    # vertical: BOTTOM axis is the discrete x domain → category labels
    svg_v = _render(BAR_QUERY.format(" WITH AXIS BOTTOM"))
    assert "Tokyo" in svg_v
    # horizontal: BOTTOM axis is the continuous y domain → numbers
    svg_h = _render(BAR_QUERY.format(" WITH ORIENTATION HORIZONTAL AXIS BOTTOM"))
    assert "Tokyo" not in svg_h.split("bars horizontal")[0]


def test_areachart_fill_path(reference_dir):
    svg = _render(
        """
        DRAW AREACHART;
        SELECT temperature AS x, temperature AS y FROM city_temperatures LIMIT 5;
        """
    )
    assert "<g class='areas'>" in svg
    # one closed area path per series; default line/point styles "none"
    assert svg.count("class='area ") == 1
    assert "class='line " not in svg
    # points drawn with r='0.0' (pointstyle none quirk, like linechart)
    assert "r='0.000000'" in svg


def test_pointchart_points(reference_dir):
    svg = _render(
        """
        DRAW POINTCHART;
        SELECT temperature AS x, temperature AS y FROM city_temperatures LIMIT 5;
        """
    )
    assert "<g class='points'>" in svg
    assert svg.count("<circle") == 5


def test_discrete_domain_reference_quirks():
    # reference discretedomain.h:45-60: index measured from the END —
    # first category added scales nearest 1.0
    d = DiscreteDomain()
    d.add_value("a")
    d.add_value("b")
    d.add_value("c")
    d.add_value("a")  # dup ignored
    assert d.scale("a") == pytest.approx((3 - 0.5) / 3)
    assert d.scale("c") == pytest.approx((1 - 0.5) / 3)
    assert d.scale_range("a") == (pytest.approx(2 / 3), pytest.approx(1.0))
    assert d.get_ticks() == [
        0.0,
        pytest.approx(1.0),
        pytest.approx(2 / 3),
        pytest.approx(1 / 3),
    ]
    with pytest.raises(Exception) as exc:
        d.scale("missing")
    assert "can't scale value" in str(exc.value)


def test_barchart_negative_values_map_below_zero():
    # BarChart2D null-coord mapping (barchart.h:585-597): y<0 → (y, 0)
    from eventql_tpu.exec.chart import BarChart, Series

    chart = BarChart()
    s = Series("")
    s.points = [("a", 5.0, "a: 5"), ("b", -3.0, "b: -3")]
    chart.add_series(s, x_is_time=False)
    assert chart._bars["a"]["ys"] == [(0.0, 5.0)]
    assert chart._bars["b"]["ys"] == [(-3.0, 0.0)]
    # stacked extends the y domain by per-bar totals
    chart.set_stacked(True)
    assert chart.y_domain.max_value >= 5.0


def test_grid_rendering(reference_dir):
    svg = _render(
        """
        DRAW LINECHART GRID HORIZONTAL VERTICAL AXIS BOTTOM;
        SELECT temperature AS x, temperature AS y FROM city_temperatures LIMIT 6;
        """
    )
    assert "<g class='grid horizontal'>" in svg
    assert "<g class='grid vertical'>" in svg
    assert svg.count("class='gridline'") >= 6


def test_legend_rendering(reference_dir):
    svg = _render(
        """
        DRAW LINECHART LEGEND TOP RIGHT OUTSIDE TITLE "cities" AXIS BOTTOM;
        SELECT city AS series, temperature AS x, temperature AS y
          FROM city_temperatures;
        """
    )
    assert "<g class='legend'>" in svg
    assert ">cities</text>" in svg
    # one legend label per series (4 cities in the fixture)
    assert svg.count("class='label'") >= 4
    assert "Tokyo" in svg


def test_barchart_grid_follows_orientation(reference_dir):
    # vertical orientation: GRID VERTICAL takes the y (continuous)
    # domain (barchart.h:322-346) — six default ticks, not categories
    svg = _render(BAR_QUERY.format(" WITH GRID VERTICAL"))
    assert "<g class='grid vertical'>" in svg


def test_domain_definitions(reference_dir):
    """XDOMAIN/YDOMAIN min/max + INVERT + LOGARITHMIC (reference:
    applyDomainDefinitions + continuousdomain.h:60-131)."""
    svg = _render(
        """
        DRAW LINECHART YDOMAIN 0, 100 AXIS LEFT;
        SELECT temperature AS x, temperature AS y FROM city_temperatures;
        """
    )
    # fixed max: the left axis top label is 100 (no padding past the max)
    assert ">100.0</text>" in svg and ">0</text>" in svg

    svg_inv = _render(
        """
        DRAW LINECHART YDOMAIN 0, 100 INVERT AXIS LEFT;
        SELECT temperature AS x, temperature AS y FROM city_temperatures;
        """
    )
    assert svg != svg_inv  # inversion flips point positions

    svg_log = _render(
        """
        DRAW LINECHART YDOMAIN LOGARITHMIC AXIS LEFT;
        SELECT temperature AS x, temperature + 50 AS y FROM city_temperatures;
        """
    )
    assert "<g class='points'>" not in svg_log  # still a linechart
    assert "<path" in svg_log


def test_domain_min_max_expressions():
    from eventql_tpu.exec.chart import ContinuousDomain

    d = ContinuousDomain()
    d.add_value(5.0)
    d.add_value(42.0)
    d.set_min(0)
    d.set_max(100)
    d.build()
    assert d.scale(50) == 0.5
    d.set_inverted(True)
    assert d.scale(50) == 0.5
    assert d.scale(25) == 0.75
    # logarithmic: scale(10) with max 100 → log10(10)/log10(100) = 0.5
    d2 = ContinuousDomain()
    d2.add_value(1.0)
    d2.add_value(100.0)
    d2.set_logarithmic(True)
    d2.build()
    assert abs(d2.scale(10) - 0.5) < 1e-9
