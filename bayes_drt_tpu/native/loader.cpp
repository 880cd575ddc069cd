// Fast batched EIS spectrum loader.
//
// The reference loads spectra one pandas.read_csv at a time in a Python loop
// (reference: code_EchemActa/"Run fits.ipynb" batch cells). Feeding the
// batch API with thousands of spectra makes parsing a measurable cost;
// this loader parses the standard simulated-data CSV layout
// (header "...Freq,Zreal,Zimag,..." with arbitrary extra columns) and Gamry
// ZCURVE tables with a single pass per file, no Python object churn.
//
// C ABI (ctypes): all functions return the number of rows parsed, or a
// negative error code.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// split a header line on commas (CSV) or tabs (Gamry)
std::vector<std::string> split(const std::string& line, char sep) {
    std::vector<std::string> out;
    size_t start = 0;
    while (true) {
        size_t end = line.find(sep, start);
        if (end == std::string::npos) {
            out.push_back(line.substr(start));
            break;
        }
        out.push_back(line.substr(start, end - start));
        start = end + 1;
    }
    return out;
}

std::string strip(const std::string& s) {
    size_t a = 0, b = s.size();
    while (a < b && std::isspace(static_cast<unsigned char>(s[a]))) ++a;
    while (b > a && std::isspace(static_cast<unsigned char>(s[b - 1]))) --b;
    return s.substr(a, b - a);
}

bool read_file(const char* path, std::string* out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long n = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    out->resize(static_cast<size_t>(n));
    size_t got = std::fread(out->empty() ? nullptr : &(*out)[0], 1,
                            static_cast<size_t>(n), f);
    std::fclose(f);
    out->resize(got);
    return true;
}

// parse rows with columns at indices (fi, ri, ii) separated by `sep`
int64_t parse_rows(const char* p, const char* end, char sep, int fi, int ri,
                   int ii, double* freq, double* zre, double* zim,
                   int64_t max_rows) {
    int64_t row = 0;
    while (p < end && row < max_rows) {
        const char* line_end = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(end - p)));
        if (!line_end) line_end = end;
        // walk columns
        int col = 0;
        const char* cp = p;
        double vals[3];
        bool have[3] = {false, false, false};
        bool bad = false;
        while (cp < line_end) {
            const char* cell_end = cp;
            while (cell_end < line_end && *cell_end != sep) ++cell_end;
            if (col == fi || col == ri || col == ii) {
                char* conv_end = nullptr;
                std::string cell(cp, cell_end);
                double v = std::strtod(cell.c_str(), &conv_end);
                if (conv_end == cell.c_str()) { bad = true; break; }
                int slot = (col == fi) ? 0 : (col == ri) ? 1 : 2;
                vals[slot] = v;
                have[slot] = true;
            }
            ++col;
            cp = cell_end + 1;
        }
        if (!bad && have[0] && have[1] && have[2]) {
            freq[row] = vals[0];
            zre[row] = vals[1];
            zim[row] = vals[2];
            ++row;
        } else if (row > 0) {
            break;  // trailing footer after data: stop
        }
        p = line_end + 1;
    }
    return row;
}

}  // namespace

extern "C" {

// Parse a CSV with Freq/Zreal/Zimag columns (any order, extra columns ok).
int64_t load_eis_csv(const char* path, double* freq, double* zre, double* zim,
                     int64_t max_rows) {
    std::string txt;
    if (!read_file(path, &txt)) return -1;
    size_t hdr_end = txt.find('\n');
    if (hdr_end == std::string::npos) return -2;
    std::vector<std::string> header = split(txt.substr(0, hdr_end), ',');
    int fi = -1, ri = -1, ii = -1;
    for (size_t i = 0; i < header.size(); ++i) {
        std::string h = strip(header[i]);
        if (h == "Freq") fi = static_cast<int>(i);
        else if (h == "Zreal") ri = static_cast<int>(i);
        else if (h == "Zimag") ii = static_cast<int>(i);
    }
    if (fi < 0 || ri < 0 || ii < 0) return -3;
    const char* p = txt.c_str() + hdr_end + 1;
    return parse_rows(p, txt.c_str() + txt.size(), ',', fi, ri, ii, freq, zre,
                      zim, max_rows);
}

// Parse the ZCURVE table of a Gamry EXPLAIN (.DTA) file.
int64_t load_eis_gamry(const char* path, double* freq, double* zre,
                       double* zim, int64_t max_rows) {
    std::string txt;
    if (!read_file(path, &txt)) return -1;
    size_t z = txt.find("ZCURVE");
    if (z == std::string::npos) return -2;
    // header line is the line after the ZCURVE line; units line follows
    size_t h0 = txt.find('\n', z) + 1;
    size_t h1 = txt.find('\n', h0);
    size_t u1 = txt.find('\n', h1 + 1);
    if (h0 == std::string::npos || h1 == std::string::npos) return -2;
    std::vector<std::string> header = split(txt.substr(h0, h1 - h0), '\t');
    int fi = -1, ri = -1, ii = -1;
    for (size_t i = 0; i < header.size(); ++i) {
        std::string h = strip(header[i]);
        if (h == "Freq") fi = static_cast<int>(i);
        else if (h == "Zreal") ri = static_cast<int>(i);
        else if (h == "Zimag") ii = static_cast<int>(i);
    }
    if (fi < 0 || ri < 0 || ii < 0) return -3;
    const char* p = txt.c_str() + u1 + 1;
    return parse_rows(p, txt.c_str() + txt.size(), '\t', fi, ri, ii, freq, zre,
                      zim, max_rows);
}

}  // extern "C"
