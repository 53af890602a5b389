// The OpenEXR library as an oracle for the port's reader
// (uncltmo_tpu_torch/utils/exr.py): it writes scanline files from raw
// planes and dumps the library's decode of each channel as raw bits.
//
// Build (scripts/make_exr_fixtures.py does this into build/):
//   g++ -O2 -std=c++17 -I/usr/include/OpenEXR -I/usr/include/Imath \
//       scripts/exr_oracle.cpp -o build/exr_oracle \
//       -lOpenEXR-3_1 -lImath-3_1 -lIex-3_1
//
// Usage:
//   exr_oracle write OUT.exr COMP LEVEL X0 Y0 W H RAW NAME:TYPE:XS:YS:PLIN...
//       RAW holds each named channel's samples in turn, each its own
//       (ny_c, nx_c) plane of little-endian TYPE (uint, half or float):
//       the samples at x % XS == 0 and y % YS == 0 of the data window
//       (X0, Y0)-(X0+W-1, Y0+H-1).  COMP: NONE, RLE, ZIPS, ZIP, PIZ, PXR24,
//       B44, B44A, DWAA or DWAB; LEVEL: the dwaCompressionLevel.
//   exr_oracle yc OUT.exr COMP LEVEL W H yc|yca RAW
//       RAW is (H, W, 4) half RGBA; RgbaOutputFile writes it as Y, RY, BY
//       (2x2 subsampled chroma) and, for yca, A.
//   exr_oracle read IN.exr OUT.raw
//       writes each channel's (ny_c, nx_c) plane in the file's channel
//       order to OUT.raw, and prints "NAME TYPE XS YS NX NY" a channel.
#include <ImfChannelList.h>
#include <ImfCompression.h>
#include <ImfFrameBuffer.h>
#include <ImfHeader.h>
#include <ImfInputFile.h>
#include <ImfOutputFile.h>
#include <ImfRgbaFile.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <iostream>
#include <iterator>
#include <sstream>
#include <string>
#include <vector>

using namespace Imf;
using namespace Imath;

namespace {

const char* kComp[] = {"NONE", "RLE", "ZIPS", "ZIP", "PIZ", "PXR24",
                       "B44", "B44A", "DWAA", "DWAB"};
const char* kType[] = {"uint", "half", "float"};

Compression compression(const std::string& name) {
    for (int i = 0; i < 10; ++i)
        if (name == kComp[i]) return Compression(i);
    throw std::runtime_error("unknown compression " + name);
}

PixelType pixel_type(const std::string& name) {
    for (int i = 0; i < 3; ++i)
        if (name == kType[i]) return PixelType(i);
    throw std::runtime_error("unknown pixel type " + name);
}

size_t type_size(PixelType t) { return t == HALF ? 2 : 4; }

// numSamples of ImfMisc: the x in [a, b] with x % s == 0
int count(int s, int a, int b) {
    auto divp = [](int x, int y) {
        return x >= 0 ? x / y : -((y - 1 - x) / y);
    };
    int a1 = divp(a, s), b1 = divp(b, s);
    return b1 - a1 + ((a1 * s < a) ? 0 : 1);
}

int first(int s, int a) {      // the first multiple of s at or after a
    int q = a >= 0 ? (a + s - 1) / s : -((-a) / s);
    return q * s;
}

std::vector<char> slurp(const char* path) {
    std::ifstream f(path, std::ios::binary);
    return std::vector<char>(std::istreambuf_iterator<char>(f), {});
}

int write(int argc, char** argv) {
    std::string out = argv[2];
    Compression comp = compression(argv[3]);
    float level = std::atof(argv[4]);
    int x0 = std::atoi(argv[5]), y0 = std::atoi(argv[6]);
    int w = std::atoi(argv[7]), h = std::atoi(argv[8]);
    std::vector<char> raw = slurp(argv[9]);
    Box2i window(V2i(x0, y0), V2i(x0 + w - 1, y0 + h - 1));
    Header header(window, window);
    header.compression() = comp;
    header.dwaCompressionLevel() = level;
    FrameBuffer fb;
    size_t pos = 0;
    for (int i = 10; i < argc; ++i) {
        std::stringstream ss(argv[i]);
        std::string name, type, xs, ys, plin;
        std::getline(ss, name, ':');
        std::getline(ss, type, ':');
        std::getline(ss, xs, ':');
        std::getline(ss, ys, ':');
        std::getline(ss, plin, ':');
        PixelType t = pixel_type(type);
        int sx = std::stoi(xs), sy = std::stoi(ys);
        header.channels().insert(name, Channel(t, sx, sy, plin == "1"));
        int nx = count(sx, x0, x0 + w - 1), ny = count(sy, y0, y0 + h - 1);
        size_t xst = type_size(t), yst = xst * nx;
        char* base = raw.data() + pos
                     - (first(sx, x0) / sx) * xst - (first(sy, y0) / sy) * yst;
        fb.insert(name, Slice(t, base, xst, yst, sx, sy));
        pos += yst * ny;
    }
    if (pos != raw.size()) throw std::runtime_error("raw size mismatch");
    OutputFile file(out.c_str(), header);
    file.setFrameBuffer(fb);
    file.writePixels(h);
    return 0;
}

int yc(int argc, char** argv) {
    std::string out = argv[2];
    Compression comp = compression(argv[3]);
    float level = std::atof(argv[4]);
    int w = std::atoi(argv[5]), h = std::atoi(argv[6]);
    std::string mode = argv[7];
    std::vector<char> raw = slurp(argv[8]);
    if (raw.size() != size_t(w) * h * sizeof(Rgba))
        throw std::runtime_error("raw size mismatch");
    Header header(w, h);
    header.compression() = comp;
    header.dwaCompressionLevel() = level;
    RgbaOutputFile file(out.c_str(), header,
                        mode == "yca" ? WRITE_YCA : WRITE_YC);
    file.setFrameBuffer(reinterpret_cast<Rgba*>(raw.data()), 1, w);
    file.writePixels(h);
    return 0;
}

int read(char** argv) {
    InputFile file(argv[2]);
    const Header& header = file.header();
    Box2i dw = header.dataWindow();
    std::vector<std::vector<char>> planes;
    FrameBuffer fb;
    std::ostringstream info;
    for (ChannelList::ConstIterator c = header.channels().begin();
         c != header.channels().end(); ++c) {
        const Channel& ch = c.channel();
        int nx = count(ch.xSampling, dw.min.x, dw.max.x);
        int ny = count(ch.ySampling, dw.min.y, dw.max.y);
        size_t xst = type_size(ch.type), yst = xst * nx;
        planes.emplace_back(yst * ny);
        char* base = planes.back().data()
                     - (first(ch.xSampling, dw.min.x) / ch.xSampling) * xst
                     - (first(ch.ySampling, dw.min.y) / ch.ySampling) * yst;
        fb.insert(c.name(), Slice(ch.type, base, xst, yst, ch.xSampling,
                                  ch.ySampling));
        info << c.name() << ' ' << kType[ch.type] << ' ' << ch.xSampling
             << ' ' << ch.ySampling << ' ' << nx << ' ' << ny << '\n';
    }
    file.setFrameBuffer(fb);
    file.readPixels(dw.min.y, dw.max.y);
    std::ofstream f(argv[3], std::ios::binary);
    for (auto& p : planes) f.write(p.data(), p.size());
    std::cout << info.str();
    return 0;
}

}  // namespace

int main(int argc, char** argv) {
    try {
        std::string mode = argc > 1 ? argv[1] : "";
        if (mode == "write" && argc >= 11) return write(argc, argv);
        if (mode == "yc" && argc == 9) return yc(argc, argv);
        if (mode == "read" && argc == 4) return read(argv);
        std::fprintf(stderr, "usage: see the head of exr_oracle.cpp\n");
        return 2;
    } catch (const std::exception& e) {
        std::fprintf(stderr, "exr_oracle: %s\n", e.what());
        return 1;
    }
}
